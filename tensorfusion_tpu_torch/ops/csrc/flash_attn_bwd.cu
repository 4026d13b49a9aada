// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces the two Pallas TPU kernels of `_flash_bwd_pallas`
// (tensorfusion_tpu/ops/flash_attention.py:249-295): `_dq_kernel`
// (:158-199) and `_dkv_kernel` (:202-246).  Same math, from the forward's
// per-row logsumexp L and the row constant delta = rowsum(dO * O), both f32:
//   S  = scale * Q K^T (f32 from the input-dtype operands), then the causal
//        mask writes NEG_INF = -1e30 where key > query;
//   P  = exp(S - L)            (masked entries give exactly 0);
//   dP = dO V^T;  dS = P * (dP - delta);
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO.
// In bf16, P is rounded to bf16 before P^T dO and dS before dS K and
// dS^T Q, as the TPU kernels cast them (:194-195, :235-241); every product
// accumulates in f32 and nothing else is rounded.
//
// What bounds them on this card.  At the training shape (bf16, BH = 128,
// T = 1024, D = 128, causal) dQ does 6 * D FLOPs per visible query-key
// pair (51.6 GFLOP) against 169 MB moved, dK/dV 8 * D (68.8 GFLOP) against
// 202 MB: about 300 and 340 operations per byte, past the H100's bf16
// ridge point (~295), so both are bound by the tensor cores.
//
// Design.  The TPU grids walk the other operand's tiles along a
// sequential third axis and carry the f32 accumulators in VMEM scratch.
// GPU blocks run in no order, so here one block owns one output tile and
// loops over the other axis itself: no atomics and no second pass.
// - dQ: one block per (bh, 64-row query tile), four warps of 16 query
//   rows; Q, dO and the rows' L and delta stay resident while the block
//   walks the 64-key K/V tiles up to the diagonal.  S = Q K^T and
//   dP = dO V^T take K and V as the forward's Q K^T takes K; dS K takes K
//   as the forward's P V takes V, with dS reused from registers as the A
//   operand.
// - dK/dV: one block per (bh, 64-key tile), four warps of 16 keys; K and V
//   stay resident while the block walks the 32-query Q/dO tiles from the
//   diagonal to the end.  It works in the transposed frame, so that a
//   warp's rows are keys: S^T = K Q^T, P^T = exp(S^T - L[col]),
//   dV += P^T dO, dP^T = V dO^T, dS^T = P^T * (dP^T - delta[col]),
//   dK += dS^T Q; the tile's L and delta are staged in shared memory.
//   The 32-query tile keeps the score fragments small beside the two
//   16 x D f32 accumulators (128 registers a thread at D = 128).
// bf16 runs on the tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate); tiles are staged through padded shared memory (row stride
// D + 8) with the ragged edge zero-filled and masked, so any T is taken.
// f32 keeps full f32 products (no TF32): one warp per output row, one
// key (dQ) or query (dK/dV) per lane, plain FMA.  Not yet done here:
// cp.async/TMA double-buffering, ldmatrix, wgmma.
//
// Interface: plain C, bound with ctypes.  Each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBM = 64;   // output rows per block (queries for dQ, keys for dK/dV)
constexpr int kWarps = kBM / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 64;  // keys per K/V tile of the dQ loop
constexpr int kTileQ = 32;  // queries per Q/dO tile of the dK/dV loop

template <int D>
__host__ __device__ constexpr int smem_stride() { return D + 8; }  // bf16 elements per row

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return (2 * kBM + 2 * kTileK) * smem_stride<D>() * 2;
}

template <int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return (2 * kBM + 2 * kTileQ) * smem_stride<D>() * 2 + 2 * kTileQ * 4;
}

// D = C + A * B for one m16n8k16 tile; A row-major 16x16, B "col" 16x8.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + rows) of a [t, D] matrix into shared memory with
// stride D + 8, 16 bytes a thread; rows at or past t are zero-filled so
// that a zero probability never meets a NaN from unwritten memory.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int rows, int t) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * smem_stride<D>() + c * 8) = val;
  }
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// shared-memory tile (row-major, stride S).
template <int S>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* tile, int r0, int c0,
                                       int g, int tg) {
  const __nv_bfloat16* p0 = tile + (r0 + g) * S + c0 + tg * 2;
  const __nv_bfloat16* p1 = p0 + 8 * S;
  a[0] = ld_u32(p0);
  a[1] = ld_u32(p1);
  a[2] = ld_u32(p0 + 8);
  a[3] = ld_u32(p1 + 8);
}

// B fragment with B[k][n] = tile[n0 + n][c0 + k]: the tile's rows are the
// product's columns (K in Q K^T).
template <int S>
__device__ __forceinline__ void load_b_rows(uint32_t b[2], const __nv_bfloat16* tile, int n0,
                                            int c0, int g, int tg) {
  const __nv_bfloat16* p = tile + (n0 + g) * S + c0 + tg * 2;
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// B fragment with B[k][n] = tile[k0 + k][n0 + n]: the tile's rows are the
// product's depth (V in P V).
template <int S>
__device__ __forceinline__ void load_b_cols(uint32_t b[2], const __nv_bfloat16* tile, int k0,
                                            int n0, int g, int tg) {
  const __nv_bfloat16* p = tile + (k0 + tg * 2) * S + n0 + g;
  b[0] = pack_bf16x2(p[0], p[S]);
  b[1] = pack_bf16x2(p[8 * S], p[9 * S]);
}

// Two accumulator fragments (columns 16c .. 16c + 15 of one 16-row
// block) rounded to bf16 as one A fragment.
__device__ __forceinline__ void pack_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_f32x2(lo[0], lo[1]);
  a[1] = pack_f32x2(lo[2], lo[3]);
  a[2] = pack_f32x2(hi[0], hi[1]);
  a[3] = pack_f32x2(hi[2], hi[3]);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int t, float scale, int causal) {
  constexpr int S = smem_stride<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdo = sq + kBM * S;
  __nv_bfloat16* sk = sdo + kBM * S;
  __nv_bfloat16* sv = sk + kTileK * S;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const size_t base = (size_t)bh * t * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int tg = lane & 3;  // thread in group
  const int wr = warp * 16;

  load_tile_bf16<D>(sq, q + base, q0, kBM, t);
  load_tile_bf16<D>(sdo, dout + base, q0, kBM, t);

  // Index 0: query row q0 + wr + g (fragment elements 0, 1); index 1: row + 8.
  // Rows past t read L = delta = 0: their zero dO gives dS = 0.
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < t;
    row_lse[r] = in ? lse[(size_t)bh * t + rows[r]] : 0.f;
    row_delta[r] = in ? delta[(size_t)bh * t + rows[r]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // Causal: tiles that start past the block's last query row hold no
  // visible key and are skipped; the diagonal tiles are masked per element.
  const int kv_end = causal ? min(t, q0 + kBM) : t;
  for (int n0 = 0; n0 < kv_end; n0 += kTileK) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile_bf16<D>(sk, k + base, n0, kTileK, t);
    load_tile_bf16<D>(sv, v + base, n0, kTileK, t);
    __syncthreads();

    float s[kTileK / 8][4], dp[kTileK / 8][4];
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<S>(qa, sq, wr, kk * 16, g, tg);
      load_a<S>(da, sdo, wr, kk * 16, g, tg);
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        uint32_t b[2];
        load_b_rows<S>(b, sk, j * 8, kk * 16, g, tg);
        mma_bf16(s[j], qa, b);
        load_b_rows<S>(b, sv, j * 8, kk * 16, g, tg);
        mma_bf16(dp[j], da, b);
      }
    }

    // dS = P * (dP - delta), written over s
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + tg * 2 + (e & 1);
        const int r = e >> 1;
        float x = s[j][e] * scale;
        if (key >= t || (causal && key > rows[r])) x = kNegInf;
        const float p = expf(x - row_lse[r]);
        s[j][e] = p * (dp[j][e] - row_delta[r]);
      }
    }

    // acc += dS K, dS rounded to bf16
#pragma unroll
    for (int c = 0; c < kTileK / 16; ++c) {
      uint32_t a[4];
      pack_a(a, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b[2];
        load_b_cols<S>(b, sk, c * 16, j * 8, g, tg);
        mma_bf16(acc[j], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < t) {
      __nv_bfloat16* drow = dq + base + (size_t)rows[r] * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(drow + j * 8 + tg * 2) =
            __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t,
                float scale, int causal) {
  constexpr int S = smem_stride<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + kBM * S;
  __nv_bfloat16* sq = sv + kBM * S;
  __nv_bfloat16* sdo = sq + kTileQ * S;
  float* slse = reinterpret_cast<float*>(sdo + kTileQ * S);
  float* sdelta = slse + kTileQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBM;
  const size_t base = (size_t)bh * t * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wr = warp * 16;

  load_tile_bf16<D>(sk, k + base, k0, kBM, t);
  load_tile_bf16<D>(sv, v + base, k0, kBM, t);

  // Index 0: key k0 + wr + g (fragment elements 0, 1); index 1: key + 8.
  const int keys[2] = {k0 + wr + g, k0 + wr + g + 8};
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;
  }

  // Causal: queries before the block's first key see none of its keys;
  // k0 is a multiple of the query tile, so the walk starts at k0.
  for (int m0 = causal ? k0 : 0; m0 < t; m0 += kTileQ) {
    __syncthreads();
    load_tile_bf16<D>(sq, q + base, m0, kTileQ, t);
    load_tile_bf16<D>(sdo, dout + base, m0, kTileQ, t);
    for (int i = threadIdx.x; i < kTileQ; i += kThreads) {
      const bool in = m0 + i < t;
      slse[i] = in ? lse[(size_t)bh * t + m0 + i] : 0.f;
      sdelta[i] = in ? delta[(size_t)bh * t + m0 + i] : 0.f;
    }
    __syncthreads();

    float st[kTileQ / 8][4], dpt[kTileQ / 8][4];
#pragma unroll
    for (int j = 0; j < kTileQ / 8; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<S>(ka, sk, wr, kk * 16, g, tg);
      load_a<S>(va, sv, wr, kk * 16, g, tg);
#pragma unroll
      for (int j = 0; j < kTileQ / 8; ++j) {
        uint32_t b[2];
        load_b_rows<S>(b, sq, j * 8, kk * 16, g, tg);
        mma_bf16(st[j], ka, b);
        load_b_rows<S>(b, sdo, j * 8, kk * 16, g, tg);
        mma_bf16(dpt[j], va, b);
      }
    }

    // P^T over st
#pragma unroll
    for (int j = 0; j < kTileQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tg * 2 + (e & 1);
        const int query = m0 + col;
        const int key = keys[e >> 1];
        float x = st[j][e] * scale;
        if (query >= t || key >= t || (causal && key > query)) x = kNegInf;
        st[j][e] = expf(x - slse[col]);
      }
    }

    // dV += P^T dO, P^T rounded to bf16
#pragma unroll
    for (int c = 0; c < kTileQ / 16; ++c) {
      uint32_t a[4];
      pack_a(a, st[2 * c], st[2 * c + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b[2];
        load_b_cols<S>(b, sdo, c * 16, j * 8, g, tg);
        mma_bf16(acc_v[j], a, b);
      }
    }

    // dS^T = P^T * (dP^T - delta[col]), written over dpt
#pragma unroll
    for (int j = 0; j < kTileQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tg * 2 + (e & 1);
        dpt[j][e] = st[j][e] * (dpt[j][e] - sdelta[col]);
      }
    }

    // dK += dS^T Q, dS^T rounded to bf16
#pragma unroll
    for (int c = 0; c < kTileQ / 16; ++c) {
      uint32_t a[4];
      pack_a(a, dpt[2 * c], dpt[2 * c + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b[2];
        load_b_cols<S>(b, sq, c * 16, j * 8, g, tg);
        mma_bf16(acc_k[j], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] < t) {
      __nv_bfloat16* krow = dk + base + (size_t)keys[r] * D;
      __nv_bfloat16* vrow = dv + base + (size_t)keys[r] * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(krow + j * 8 + tg * 2) =
            __floats2bfloat162_rn(acc_k[j][2 * r] * scale, acc_k[j][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + j * 8 + tg * 2) =
            __floats2bfloat162_rn(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: full-precision FMA, one warp per output row, one column per lane
// ---------------------------------------------------------------------------

constexpr int kRowsF = 8;   // output rows (warps) per block
constexpr int kColsF = 32;  // keys (dQ) or queries (dK/dV) per tile, one per lane

template <int D>
__global__ void __launch_bounds__(kRowsF * 32)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int t, float scale, int causal) {
  constexpr int kPerLane = (D + 31) / 32;  // output columns a lane owns
  __shared__ float sq[kRowsF][D];
  __shared__ float sdo[kRowsF][D];
  __shared__ float sk[kColsF][D + 1];  // +1: lane j reads row j without conflicts
  __shared__ float sv[kColsF][D + 1];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowsF;
  const size_t base = (size_t)bh * t * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = q0 + warp;

  for (int i = threadIdx.x; i < kRowsF * D; i += kRowsF * 32) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < t;
    sq[r][c] = in ? q[base + (size_t)(q0 + r) * D + c] : 0.f;
    sdo[r][c] = in ? dout[base + (size_t)(q0 + r) * D + c] : 0.f;
  }
  const float row_lse = row < t ? lse[(size_t)bh * t + row] : 0.f;
  const float row_delta = row < t ? delta[(size_t)bh * t + row] : 0.f;

  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;

  const int kv_end = causal ? min(t, q0 + kRowsF) : t;
  for (int n0 = 0; n0 < kv_end; n0 += kColsF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kColsF * D; i += kRowsF * 32) {
      const int r = i / D, c = i % D;
      const bool in = n0 + r < t;
      sk[r][c] = in ? k[base + (size_t)(n0 + r) * D + c] : 0.f;
      sv[r][c] = in ? v[base + (size_t)(n0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    const int key = n0 + lane;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      s = fmaf(sq[warp][d], sk[lane][d], s);
      dp = fmaf(sdo[warp][d], sv[lane][d], dp);
    }
    s *= scale;
    if (key >= t || (causal && key > row)) s = kNegInf;
    const float ds = expf(s - row_lse) * (dp - row_delta);
    for (int j = 0; j < kColsF; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(dsj, sk[j][d], acc[i]);
      }
    }
  }

  if (row < t) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dq[base + (size_t)row * D + d] = acc[i] * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kRowsF * 32)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int t, float scale, int causal) {
  constexpr int kPerLane = (D + 31) / 32;
  __shared__ float sk[kRowsF][D];
  __shared__ float sv[kRowsF][D];
  __shared__ float sq[kColsF][D + 1];
  __shared__ float sdo[kColsF][D + 1];
  __shared__ float slse[kColsF];
  __shared__ float sdelta[kColsF];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRowsF;
  const size_t base = (size_t)bh * t * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int key = k0 + warp;

  for (int i = threadIdx.x; i < kRowsF * D; i += kRowsF * 32) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < t;
    sk[r][c] = in ? k[base + (size_t)(k0 + r) * D + c] : 0.f;
    sv[r][c] = in ? v[base + (size_t)(k0 + r) * D + c] : 0.f;
  }

  float acc_k[kPerLane], acc_v[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc_k[i] = acc_v[i] = 0.f;

  // Causal: start at the query tile that holds the block's first key.
  for (int m0 = causal ? (k0 / kColsF) * kColsF : 0; m0 < t; m0 += kColsF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kColsF * D; i += kRowsF * 32) {
      const int r = i / D, c = i % D;
      const bool in = m0 + r < t;
      sq[r][c] = in ? q[base + (size_t)(m0 + r) * D + c] : 0.f;
      sdo[r][c] = in ? dout[base + (size_t)(m0 + r) * D + c] : 0.f;
    }
    if (threadIdx.x < kColsF) {
      const bool in = m0 + threadIdx.x < t;
      slse[threadIdx.x] = in ? lse[(size_t)bh * t + m0 + threadIdx.x] : 0.f;
      sdelta[threadIdx.x] = in ? delta[(size_t)bh * t + m0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    const int query = m0 + lane;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      s = fmaf(sk[warp][d], sq[lane][d], s);
      dp = fmaf(sv[warp][d], sdo[lane][d], dp);
    }
    s *= scale;
    if (query >= t || key >= t || (causal && key > query)) s = kNegInf;
    const float p = expf(s - slse[lane]);
    const float ds = p * (dp - sdelta[lane]);
    for (int j = 0; j < kColsF; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          acc_v[i] = fmaf(pj, sdo[j][d], acc_v[i]);
          acc_k[i] = fmaf(dsj, sq[j][d], acc_k[i]);
        }
      }
    }
  }

  if (key < t) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dk[base + (size_t)key * D + d] = acc_k[i] * scale;
        dv[base + (size_t)key * D + d] = acc_v[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  int bh, t;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t dq_bf16(const BwdArgs& a, void* dq) {
  constexpr int bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dq_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t + kBM - 1) / kBM, a.bh);
  dq_bf16_kernel<D><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
      a.delta, static_cast<__nv_bfloat16*>(dq), a.t, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_bf16(const BwdArgs& a, void* dk, void* dv) {
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dkv_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t + kBM - 1) / kBM, a.bh);
  dkv_bf16_kernel<D><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
      a.delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.t, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_f32(const BwdArgs& a, void* dq) {
  const dim3 grid((a.t + kRowsF - 1) / kRowsF, a.bh);
  dq_f32_kernel<D><<<grid, kRowsF * 32, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(dq), a.t, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_f32(const BwdArgs& a, void* dk, void* dv) {
  const dim3 grid((a.t + kRowsF - 1) / kRowsF, a.bh);
  dkv_f32_kernel<D><<<grid, kRowsF * 32, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(dk), static_cast<float*>(dv), a.t, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

#define TPF_DISPATCH(DTYPE, D, BF16_FN, F32_FN, ...)                     \
  do {                                                                   \
    if ((DTYPE) == 1) {                                                  \
      switch (D) {                                                       \
        case 16: return static_cast<int>(BF16_FN<16>(__VA_ARGS__));      \
        case 32: return static_cast<int>(BF16_FN<32>(__VA_ARGS__));      \
        case 64: return static_cast<int>(BF16_FN<64>(__VA_ARGS__));      \
        case 128: return static_cast<int>(BF16_FN<128>(__VA_ARGS__));    \
        default: break;                                                  \
      }                                                                  \
    } else if ((DTYPE) == 0) {                                           \
      switch (D) {                                                       \
        case 16: return static_cast<int>(F32_FN<16>(__VA_ARGS__));       \
        case 32: return static_cast<int>(F32_FN<32>(__VA_ARGS__));       \
        case 64: return static_cast<int>(F32_FN<64>(__VA_ARGS__));       \
        case 128: return static_cast<int>(F32_FN<128>(__VA_ARGS__));     \
        default: break;                                                  \
      }                                                                  \
    }                                                                    \
    return static_cast<int>(cudaErrorInvalidValue);                      \
  } while (0)

// q, k, v, dout, dq: [bh, t, d] contiguous, 16-byte aligned, all of one
// dtype; lse, delta: [bh, t] f32.  dtype: 0 = float32, 1 = bfloat16.
// d: 16, 32, 64 or 128.
extern "C" int tpf_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int bh, int t, int d, float scale, int causal,
                                     int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), bh, t, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  TPF_DISPATCH(dtype, d, dq_bf16, dq_f32, a, dq);
}

// As above; dk and dv: [bh, t, d] in the inputs' dtype.
extern "C" int tpf_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int bh, int t, int d, float scale,
                                      int causal, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), bh, t, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  TPF_DISPATCH(dtype, d, dkv_bf16, dkv_f32, a, dk, dv);
}

#undef TPF_DISPATCH
