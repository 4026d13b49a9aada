// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces the two Pallas TPU kernels of `_flash_bwd_pallas`
// (tensorfusion_tpu/ops/flash_attention.py:249-295): `_dq_kernel`
// (:158-199) and `_dkv_kernel` (:202-246).  Same math, from the forward's
// per-row logsumexp L and the row constant delta = rowsum(dO * O), both f32:
//   S  = scale * Q K^T (f32 from the input-dtype operands), causal mask
//        where key > query;
//   P  = exp(S - L)            (masked entries give exactly 0);
//   dP = dO V^T;  dS = P * (dP - delta);
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO.
// In bf16, P is rounded to bf16 before P^T dO and dS before dS K and
// dS^T Q, as the TPU kernels cast them (:194-195, :235-241); dS is formed
// from the unrounded P; every product accumulates in f32.
//
// What bounds them on this card.  At the training shape (bf16, BH = 128,
// T = 1024, D = 128, causal) dQ does 6 * D FLOPs per visible query-key
// pair (51.6 GFLOP) against 169 MB moved, dK/dV 8 * D (68.8 GFLOP) against
// 202 MB: about 300 and 340 operations per byte, past the H100's bf16
// ridge (~295), so both are bound by the tensor cores, which only wgmma
// drives at their full rate.
//
// The TPU grids walk the other operand's tiles along a sequential axis and
// carry the f32 accumulators in VMEM.  GPU blocks run in no order, so here
// one block owns one output tile and loops over the other axis itself: no
// atomics and no second pass, so every sum runs in one fixed order.
//
// Both bf16 kernels at D = 64 and 128 share one design (`dq90`, `dkv90`):
// TMA loads over 3-D tensor maps into rings of 128B-swizzled tiles with
// full and empty mbarriers, a producer warpgroup that gives its registers
// up (setmaxnreg), and two wgmma consumer warpgroups that take turns at
// issuing their products (named barriers), so one's exponentials overlap
// the other's products.  The causal mask is applied to scores, never as a
// branch around a product (a branch around wgmma makes ptxas serialize
// the products).  The 3-D maps zero-fill past T instead of reading the
// next head, and heads launch in groups whose streamed operands fit in L2.
//
// dQ, bf16 at D = 64 and 128 (`dq90`): bound by the tensor cores, as
// above, and fed from L2: each streamed 128-key K/V tile (64 KB at
// D = 128) carries 128 queries x 128 keys x 6 D FLOPs (12.6 MFLOP), so
// 700 TFLOP/s takes about 3.6 TB/s of K and V from L2.  One block of three
// warpgroups per (bh, 128-query tile).  One producer thread loads Q and dO
// once and streams 128-key K and V tiles through a two-stage ring, Q, dO,
// K and V on full barriers apart so that S = Q K^T starts before dO and V
// land.  Warpgroups 1 and 2 own 64 queries each and keep dQ as D / 64 f32
// m64n64 accumulators in registers (64 a thread at D = 128), with
// lse * log2(e) and delta of their two rows in registers (lse = +inf past
// T, so P = 0 there).  Per tile: S = Q K^T and dP = dO V^T by wgmma
// m64n128k16 from shared memory, two groups in flight so that
// P = exp2(S scale log2(e) - lse log2(e)) overlaps dP; dS = P (dP - delta)
// from the unrounded P, rounded to bf16 in registers as the A operand of
// dQ += dS K, K read transposed by the descriptor (m64n64k16 per 64
// columns of D).  K is read twice, so a stage is released only after the
// dQ product.  The walk covers keys [0, min(T, q0 + 128)), masked only on
// the tile that crosses the diagonal or T.  128-key tiles beat 64-key
// tiles in a four-stage ring (m64n64 for S and dP: the same bytes in
// flight, twice the issue turns), and no warpgroup has a tile to skip.
// Within a head group the heaviest (last) query tiles launch first.
//
// dK/dV, bf16 at D = 64 and 128 (`dkv90`): one block of three warpgroups
// per (bh, 128-key tile), in the transposed frame (rows are keys), so every
// product maps onto wgmma without reshuffling.  One producer thread loads
// K and V once and streams 64-query Q and dO tiles through a four-stage
// ring, while its warp stages each tile's lse * log2(e) and delta in
// shared memory (lse = +inf past T, so P = 0 there).  Warpgroups 1 and 2
// own 64 keys each and keep dK and dV as two 64 x D f32 accumulators in
// registers (128 a thread at D = 128, which is why they take the
// producer's registers): S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16
// from shared memory, two groups in flight so that P^T = exp2(S^T scale
// log2(e) - lse log2(e)) overlaps dP^T; then dS^T = P^T (dP^T - delta),
// and dV += P^T dO, dK += dS^T Q with P^T and dS^T rounded to bf16 in
// registers as the A operand and dO and Q read transposed by the
// descriptor.  The causal mask is a select on every tile, and the walk
// starts at the query tile of the block's first key.  Within a head group
// key tile 0, which walks every query, launches first.
//
// Other paths, chosen by dtype and D before any launch:
// - bf16 at D = 16 and 32 keeps the mma.sync m16n8k16 kernels (the 128B
//   swizzle needs 64 columns): dQ one block per (bh, 64-query tile), four
//   warps of 16 rows, Q, dO, L and delta resident while it walks 64-key
//   K/V tiles through padded shared memory; dK/dV one block per (bh,
//   64-key tile), four warps of 16 keys, 32-query Q/dO tiles.
// - f32 keeps full f32 products (no TF32): one warp per output row, one key
//   (dQ) or query (dK/dV) per lane, plain FMA.
//
// Interface: plain C, bound with ctypes.  Each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels

// ---------------------------------------------------------------------------
// bf16 dQ and dK/dV at D = 16 and 32: tensor cores through mma.sync
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
  a[0] = tpf::pack_bf16(lo[0], lo[1]);
  a[1] = tpf::pack_bf16(lo[2], lo[3]);
  a[2] = tpf::pack_bf16(hi[0], hi[1]);
  a[3] = tpf::pack_bf16(hi[2], hi[3]);
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
// bf16 dK/dV at D = 64 and 128: TMA ring and warp-specialised wgmma
// ---------------------------------------------------------------------------

namespace dkv90 {

constexpr int kBN = 128;         // keys per block, 64 per consumer warpgroup
constexpr int kBM = 64;          // queries per streamed Q/dO tile
constexpr int kStages = 4;       // depth of the Q/dO ring
constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Shared memory: K and V (resident), the Q and dO rings (each tile D / 64
// swizzled boxes of [rows, 64]), the ring's lse * log2(e) and delta rows
// ([S][2][kBM] f32), then the barriers kv_full, full[S], empty[S]; 1024
// bytes of slack align the tiles for the 128B swizzle.
template <int D>
struct Layout {
  static constexpr int kTileKV = kBN * D * 2;
  static constexpr int kTileQ = kBM * D * 2;
  static constexpr int kV = kTileKV;
  static constexpr int kQ = 2 * kTileKV;
  static constexpr int kDO = kQ + kStages * kTileQ;
  static constexpr int kRows = kDO + kStages * kTileQ;
  static constexpr int kBars = kRows + kStages * 2 * kBM * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n_bh, int t,
           float scale, int causal, int group) {
  using L = Layout<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tpf::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* const rows_smem = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  const uint32_t kv_full = base + L::kBars;
  const auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  const auto empty = [&](int s) { return kv_full + 8u * (1 + kStages + s); };
  const auto q_tile = [&](int s) { return base + L::kQ + s * L::kTileQ; };
  const auto do_tile = [&](int s) { return base + L::kDO + s * L::kTileQ; };
  const auto slse = [&](int s) { return rows_smem + s * 2 * kBM; };
  const auto sdelta = [&](int s) { return rows_smem + s * 2 * kBM + kBM; };

  // Heads launch in groups whose Q and dO stay in L2 while their blocks
  // run; within a group key tile 0, which walks every query, launches
  // first.
  int bh, kt;
  tpf::grouped_tile(blockIdx.x, n_bh, (t + kBN - 1) / kBN, group, &bh, &kt);
  const int k0 = kt * kBN;
  const int n_m = (t + kBM - 1) / kBM;
  // causal: queries before the block's first key see none of its keys
  const int m_begin = causal ? k0 / kBM : 0;

  if (threadIdx.x == 0) {
    tpf::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      tpf::mbar_init(full(s), 32);
      tpf::mbar_init(empty(s), kConsumerThreads);
    }
    tpf::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: warp 0 keeps the ring full; lane 0 issues the TMA loads and
    // every lane stages two of the tile's lse and delta entries
    tpf::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tpf::mbar_arrive_expect_tx(kv_full, 2 * L::kTileKV);
        for (int c = 0; c < kBoxes; ++c) {
          tpf::tma_load_3d(base + c * kBN * 128, &tk, kv_full, c * 64, k0, bh);
          tpf::tma_load_3d(base + L::kV + c * kBN * 128, &tv, kv_full, c * 64, k0, bh);
        }
      }
      for (int i = m_begin, j = 0; i < n_m; ++i, ++j) {
        const int s = j % kStages;
        if (j >= kStages) tpf::mbar_wait(empty(s), ((j / kStages) - 1) & 1);
        const int m0 = i * kBM;
        for (int r = lane; r < kBM; r += 32) {
          // a query past T gets lse = +inf, so its P is exactly 0
          const bool in = m0 + r < t;
          slse(s)[r] = in ? lse[(size_t)bh * t + m0 + r] * 1.4426950408889634f : INFINITY;
          sdelta(s)[r] = in ? delta[(size_t)bh * t + m0 + r] : 0.f;
        }
        if (lane == 0) {
          tpf::mbar_arrive_expect_tx(full(s), 2 * L::kTileQ);
          for (int c = 0; c < kBoxes; ++c) {
            tpf::tma_load_3d(q_tile(s) + c * kBM * 128, &tq, full(s), c * 64, m0, bh);
            tpf::tma_load_3d(do_tile(s) + c * kBM * 128, &tdo, full(s), c * 64, m0, bh);
          }
        } else {
          tpf::mbar_arrive(full(s));
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64), in the
  // transposed frame (rows are keys, columns the tile's queries)
  tpf::setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x - 128;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kw0 = k0 + 64 * wg;
  const int keys[2] = {kw0 + 16 * warp + lane / 4, kw0 + 16 * warp + lane / 4 + 8};
  const int col = 2 * (lane % 4);  // column of d[4n] within chunk n
  const float c2 = scale * 1.4426950408889634f;

  float acc_k[kBoxes][32], acc_v[kBoxes][32];
#pragma unroll
  for (int b = 0; b < kBoxes; ++b) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[b][i] = acc_v[b][i] = 0.f;
  }
  const uint32_t k_rows = base + wg * 64 * 128;
  const uint32_t v_rows = base + L::kV + wg * 64 * 128;

  // The two warpgroups take turns at issuing their products (named
  // barriers 1 and 2), twice a tile: S^T and dP^T, then dV and dK.  So
  // one's exponentials and dS^T overlap the other's products.  Warpgroup 0
  // goes first; warpgroup 1's last arrival is left on barrier 1 at exit.
  // Every tile is computed, even one wholly before a warpgroup's keys
  // (the mask zeroes it): a branch around the products would serialize
  // them.
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) tpf::named_bar_arrive(their_turn, kConsumerThreads);
  tpf::mbar_wait(kv_full, 0);
  for (int i = m_begin, j = 0; i < n_m; ++i, ++j) {
    const int s = j % kStages;
    const int m0 = i * kBM;
    float st[32], dpt[32];
    tpf::mbar_wait(full(s), (j / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, two groups in flight
    tpf::named_bar_sync(my_turn, kConsumerThreads);
    tpf::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t slice = (kk % 4) * 32;
      tpf::wgmma_m64n64_ss(st, tpf::desc_sw128(k_rows + (kk / 4) * kBN * 128 + slice),
                           tpf::desc_sw128(q_tile(s) + (kk / 4) * kBM * 128 + slice), kk > 0);
    }
    tpf::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t slice = (kk % 4) * 32;
      tpf::wgmma_m64n64_ss(dpt, tpf::desc_sw128(v_rows + (kk / 4) * kBN * 128 + slice),
                           tpf::desc_sw128(do_tile(s) + (kk / 4) * kBM * 128 + slice), kk > 0);
    }
    tpf::wgmma_commit();
    tpf::named_bar_arrive(their_turn, kConsumerThreads);

    // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)) while dP^T runs;
    // causal: column 8n + e of chunk n is hidden from key r when
    // 8n + e < limit[r]
    tpf::wgmma_wait<1>();
    tpf::fence_regs(st);
    const float* sl = slse(s);
    int limit[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) limit[r] = causal ? keys[r] - m0 - col : -1;
#pragma unroll
    for (int n = 0; n < kBM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = st[4 * n + e] * c2 - sl[8 * n + col + (e & 1)];
        st[4 * n + e] = 8 * n + (e & 1) < limit[e >> 1] ? 0.f : tpf::exp2_approx(x);
      }
    }
    // dS^T = P^T * (dP^T - delta), from the unrounded P^T
    tpf::wgmma_wait<0>();
    tpf::fence_regs(dpt);
    const float* sd = sdelta(s);
#pragma unroll
    for (int n = 0; n < kBM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - sd[8 * n + col + (e & 1)]);
    }
    // P^T and dS^T rounded to bf16 as A operands
    uint32_t pa[kBM / 16][4], da[kBM / 16][4];
#pragma unroll
    for (int c = 0; c < kBM / 16; ++c) {
      tpf::pack_a(pa[c], st, c);
      tpf::pack_a(da[c], dpt, c);
    }

    // dV += P^T dO and dK += dS^T Q, dO and Q transposed from shared memory
    tpf::named_bar_sync(my_turn, kConsumerThreads);
    tpf::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBM / 16; ++c) {
#pragma unroll
      for (int b = 0; b < kBoxes; ++b) {
        tpf::wgmma_m64n64_rs_tb(acc_v[b], pa[c],
                                tpf::desc_sw128(do_tile(s) + b * kBM * 128 + c * 2048));
        tpf::wgmma_m64n64_rs_tb(acc_k[b], da[c],
                                tpf::desc_sw128(q_tile(s) + b * kBM * 128 + c * 2048));
      }
    }
    tpf::wgmma_commit();
    tpf::named_bar_arrive(their_turn, kConsumerThreads);
    tpf::wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) {
      tpf::fence_regs(acc_k[b]);
      tpf::fence_regs(acc_v[b]);
    }
    tpf::mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] < t) {
      __nv_bfloat16* krow = dk + ((size_t)bh * t + keys[r]) * D;
      __nv_bfloat16* vrow = dv + ((size_t)bh * t + keys[r]) * D;
#pragma unroll
      for (int b = 0; b < kBoxes; ++b) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = 64 * b + 8 * n + col;
          *reinterpret_cast<__nv_bfloat162*>(krow + c) = __floats2bfloat162_rn(
              acc_k[b][4 * n + 2 * r] * scale, acc_k[b][4 * n + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(vrow + c) =
              __floats2bfloat162_rn(acc_v[b][4 * n + 2 * r], acc_v[b][4 * n + 2 * r + 1]);
        }
      }
    }
  }
}

}  // namespace dkv90

// ---------------------------------------------------------------------------
// bf16 dQ at D = 64 and 128: TMA ring and warp-specialised wgmma
// ---------------------------------------------------------------------------

namespace dq90 {

constexpr int kBM = 128;         // queries per block, 64 per consumer warpgroup
constexpr int kBN = 128;         // keys per streamed K/V tile
constexpr int kStages = 2;       // depth of the K and V rings
constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Shared memory: Q and dO (resident), the K and V rings (each tile D / 64
// swizzled boxes of [rows, 64]), then the barriers q_full, do_full,
// k_full[S], v_full[S], empty[S]; 1024 bytes of slack align the tiles for
// the 128B swizzle.
template <int D>
struct Layout {
  static constexpr int kTileQ = kBM * D * 2;
  static constexpr int kTileKV = kBN * D * 2;
  static constexpr int kDO = kTileQ;
  static constexpr int kK = 2 * kTileQ;
  static constexpr int kV = kK + kStages * kTileKV;
  static constexpr int kBars = kV + kStages * kTileKV;
  static constexpr int kBytes = kBars + 8 * (2 + 3 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int n_bh, int t, float scale, int causal, int group) {
  using L = Layout<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tpf::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t do_full = q_full + 8u;
  const auto k_full = [&](int s) { return q_full + 8u * (2 + s); };
  const auto v_full = [&](int s) { return q_full + 8u * (2 + kStages + s); };
  const auto empty = [&](int s) { return q_full + 8u * (2 + 2 * kStages + s); };
  const auto k_tile = [&](int s) { return base + L::kK + s * L::kTileKV; };
  const auto v_tile = [&](int s) { return base + L::kV + s * L::kTileKV; };

  // Heads launch in groups whose K and V stay in L2 while their blocks
  // run; within a group the heaviest (last) query tiles launch first.
  const int n_qtiles = (t + kBM - 1) / kBM;
  int bh, rank;
  tpf::grouped_tile(blockIdx.x, n_bh, n_qtiles, group, &bh, &rank);
  const int q0 = (n_qtiles - 1 - rank) * kBM;
  // causal: keys past the block's last query are hidden from all its rows
  const int kv_end = causal ? min(t, q0 + kBM) : t;
  const int n_kv = (kv_end + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    tpf::mbar_init(q_full, 1);
    tpf::mbar_init(do_full, 1);
    for (int s = 0; s < kStages; ++s) {
      tpf::mbar_init(k_full(s), 1);
      tpf::mbar_init(v_full(s), 1);
      tpf::mbar_init(empty(s), kConsumerThreads);
    }
    tpf::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread loads Q and dO once and keeps the rings full.
    // Q, dO, K and V each have their own full barriers, so S = Q K^T can
    // start before dO and V land; the first K goes before dO.
    tpf::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tpf::mbar_arrive_expect_tx(q_full, L::kTileQ);
      for (int c = 0; c < kBoxes; ++c)
        tpf::tma_load_3d(base + c * kBM * 128, &tq, q_full, c * 64, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) tpf::mbar_wait(empty(s), ((j / kStages) - 1) & 1);
        tpf::mbar_arrive_expect_tx(k_full(s), L::kTileKV);
        for (int c = 0; c < kBoxes; ++c)
          tpf::tma_load_3d(k_tile(s) + c * kBN * 128, &tk, k_full(s), c * 64, j * kBN, bh);
        if (j == 0) {
          tpf::mbar_arrive_expect_tx(do_full, L::kTileQ);
          for (int c = 0; c < kBoxes; ++c)
            tpf::tma_load_3d(base + L::kDO + c * kBM * 128, &tdo, do_full, c * 64, q0, bh);
        }
        tpf::mbar_arrive_expect_tx(v_full(s), L::kTileKV);
        for (int c = 0; c < kBoxes; ++c)
          tpf::tma_load_3d(v_tile(s) + c * kBN * 128, &tv, v_full(s), c * 64, j * kBN, bh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
  tpf::setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x - 128;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg;
  const int rows[2] = {row0 + 16 * warp + lane / 4, row0 + 16 * warp + lane / 4 + 8};
  const int col = 2 * (lane % 4);  // column of d[4n] within chunk n
  const float c2 = scale * 1.4426950408889634f;  // scores in the log2 domain

  // a row past T gets lse = +inf, so its P is exactly 0
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < t;
    row_lse[r] = in ? lse[(size_t)bh * t + rows[r]] * 1.4426950408889634f : INFINITY;
    row_delta[r] = in ? delta[(size_t)bh * t + rows[r]] : 0.f;
  }

  float acc[kBoxes][32];
#pragma unroll
  for (int b = 0; b < kBoxes; ++b) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  }
  const uint32_t q_rows = base + wg * 64 * 128;
  const uint32_t do_rows = base + L::kDO + wg * 64 * 128;

  // The two warpgroups take turns at issuing their products (named
  // barriers 1 and 2), twice a tile: S and dP, then dQ.  So one's
  // exponentials and dS overlap the other's products.  Warpgroup 0 goes
  // first; warpgroup 1's last arrival is left on barrier 1 at exit.
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) tpf::named_bar_arrive(their_turn, kConsumerThreads);
  tpf::mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int n0 = j * kBN;
    float sc[64], dp[64];

    // S = Q K^T and dP = dO V^T, two groups in flight
    tpf::mbar_wait(k_full(s), parity);
    tpf::named_bar_sync(my_turn, kConsumerThreads);
    tpf::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t slice = (kk % 4) * 32;
      tpf::wgmma_m64n128_ss(sc, tpf::desc_sw128(q_rows + (kk / 4) * kBM * 128 + slice),
                           tpf::desc_sw128(k_tile(s) + (kk / 4) * kBN * 128 + slice), kk > 0);
    }
    tpf::wgmma_commit();
    tpf::mbar_wait(do_full, 0);  // returns at once after the first tile
    tpf::mbar_wait(v_full(s), parity);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t slice = (kk % 4) * 32;
      tpf::wgmma_m64n128_ss(dp, tpf::desc_sw128(do_rows + (kk / 4) * kBM * 128 + slice),
                           tpf::desc_sw128(v_tile(s) + (kk / 4) * kBN * 128 + slice), kk > 0);
    }
    tpf::wgmma_commit();
    tpf::named_bar_arrive(their_turn, kConsumerThreads);

    // P = exp2(S * scale * log2(e) - lse * log2(e)) while dP runs; the
    // mask only where the tile crosses the diagonal or T: column 8n + e of
    // chunk n is a visible key of row r when 8n + e < limit[r]
    tpf::wgmma_wait<1>();
    tpf::fence_regs(sc);
    if ((causal && n0 + kBN - 1 > row0) || n0 + kBN > t) {
      int limit[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) limit[r] = (causal ? min(t, rows[r] + 1) : t) - n0 - col;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * n + (e & 1) >= limit[e >> 1]) sc[4 * n + e] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i)
      sc[i] = tpf::exp2_approx(fmaf(sc[i], c2, -row_lse[(i >> 1) & 1]));
    // dS = P * (dP - delta), from the unrounded P, rounded to bf16 as the
    // A operand of dQ += dS K
    tpf::wgmma_wait<0>();
    tpf::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 64; ++i) dp[i] = sc[i] * (dp[i] - row_delta[(i >> 1) & 1]);
    uint32_t da[kBN / 16][4];
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) tpf::pack_a(da[c], dp, c);

    // dQ += dS K, K read transposed from shared memory, one issue per 64
    // columns of D; K's stage is released only after this product
    tpf::named_bar_sync(my_turn, kConsumerThreads);
    tpf::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
#pragma unroll
      for (int b = 0; b < kBoxes; ++b)
        tpf::wgmma_m64n64_rs_tb(acc[b], da[c],
                                tpf::desc_sw128(k_tile(s) + b * kBN * 128 + c * 2048));
    }
    tpf::wgmma_commit();
    tpf::named_bar_arrive(their_turn, kConsumerThreads);
    tpf::wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) tpf::fence_regs(acc[b]);
    tpf::mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < t) {
      __nv_bfloat16* qrow = dq + ((size_t)bh * t + rows[r]) * D;
#pragma unroll
      for (int b = 0; b < kBoxes; ++b) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(qrow + 64 * b + 8 * n + col) = __floats2bfloat162_rn(
              acc[b][4 * n + 2 * r] * scale, acc[b][4 * n + 2 * r + 1] * scale);
        }
      }
    }
  }
}

}  // namespace dq90

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
cudaError_t dkv90_launch(const BwdArgs& a, void* dk, void* dv) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = tpf::tensor_map_bf16(&tq, a.q, a.bh, a.t, D, dkv90::kBM);
  if (err == cudaSuccess) err = tpf::tensor_map_bf16(&tk, a.k, a.bh, a.t, D, dkv90::kBN);
  if (err == cudaSuccess) err = tpf::tensor_map_bf16(&tv, a.v, a.bh, a.t, D, dkv90::kBN);
  if (err == cudaSuccess) err = tpf::tensor_map_bf16(&tdo, a.dout, a.bh, a.t, D, dkv90::kBM);
  if (err != cudaSuccess) return err;
  constexpr int bytes = dkv90::Layout<D>::kBytes;
  err = cudaFuncSetAttribute(dkv90::dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (a.t + dkv90::kBN - 1) / dkv90::kBN * a.bh;
  dkv90::dkv_kernel<D><<<blocks, dkv90::kThreads, bytes, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.bh, a.t, a.scale, a.causal,
      tpf::heads_per_group(a.bh, a.t, D));
  return cudaGetLastError();
}

// bf16 dK/dV by head dim: the Hopper design at 64 and 128, mma.sync below.
template <int D>
cudaError_t dkv_bf16_route(const BwdArgs& a, void* dk, void* dv) {
  if constexpr (D >= 64) {
    return dkv90_launch<D>(a, dk, dv);
  } else {
    return dkv_bf16<D>(a, dk, dv);
  }
}

template <int D>
cudaError_t dq90_launch(const BwdArgs& a, void* dq) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = tpf::tensor_map_bf16(&tq, a.q, a.bh, a.t, D, dq90::kBM);
  if (err == cudaSuccess) err = tpf::tensor_map_bf16(&tk, a.k, a.bh, a.t, D, dq90::kBN);
  if (err == cudaSuccess) err = tpf::tensor_map_bf16(&tv, a.v, a.bh, a.t, D, dq90::kBN);
  if (err == cudaSuccess) err = tpf::tensor_map_bf16(&tdo, a.dout, a.bh, a.t, D, dq90::kBM);
  if (err != cudaSuccess) return err;
  constexpr int bytes = dq90::Layout<D>::kBytes;
  err = cudaFuncSetAttribute(dq90::dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (a.t + dq90::kBM - 1) / dq90::kBM * a.bh;
  dq90::dq_kernel<D><<<blocks, dq90::kThreads, bytes, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(dq), a.bh, a.t, a.scale,
      a.causal, tpf::heads_per_group(a.bh, a.t, D));
  return cudaGetLastError();
}

// bf16 dQ by head dim: the Hopper design at 64 and 128, mma.sync below.
template <int D>
cudaError_t dq_bf16_route(const BwdArgs& a, void* dq) {
  if constexpr (D >= 64) {
    return dq90_launch<D>(a, dq);
  } else {
    return dq_bf16<D>(a, dq);
  }
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
  TPF_DISPATCH(dtype, d, dq_bf16_route, dq_f32, a, dq);
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
  TPF_DISPATCH(dtype, d, dkv_bf16_route, dkv_f32, a, dk, dv);
}

#undef TPF_DISPATCH

// Dynamic shared memory of one block of the bf16 dQ (which = 0) or dK/dV
// (which = 1) kernel at head dim d, in bytes; -1 for what they do not take.
extern "C" int tpf_flash_attn_bwd_smem(int d, int which) {
  switch (d) {
    case 16: return which ? dkv_smem_bytes<16>() : dq_smem_bytes<16>();
    case 32: return which ? dkv_smem_bytes<32>() : dq_smem_bytes<32>();
    case 64: return which ? dkv90::Layout<64>::kBytes : dq90::Layout<64>::kBytes;
    case 128: return which ? dkv90::Layout<128>::kBytes : dq90::Layout<128>::kBytes;
    default: return -1;
  }
}
