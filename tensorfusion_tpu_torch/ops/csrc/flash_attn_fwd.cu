// Flash-attention forward for Hopper (sm_90a): out and per-row logsumexp.
//
// Replaces the Pallas TPU kernel `_attn_kernel`, launched by
// `_flash_fwd_pallas` (tensorfusion_tpu/ops/flash_attention.py:60-155).
// Same math: S = scale * Q K^T in f32 from the input-dtype operands; the
// causal mask hides key > query; an online softmax keeps an f32 running
// max m, denominator l and output accumulator; P is rounded to V's dtype
// before the P V product, which accumulates in f32; out = acc / l with the
// l == 0 guard, lse = m + log(l) in natural log.  A masked entry gives
// exactly 0.
//
// What bounds it on this card.  At the serving shape (bf16, BH = 128,
// T = 1024, D = 128, causal) the work is 4 * D FLOPs per visible
// query-key pair, 34 GFLOP, against 134 MB of q, k, v and o: about 256
// operations per byte, near the H100's bf16 ridge (~295).  So the kernel
// is bound by how fast it feeds the tensor cores, and only wgmma reaches
// their full rate.
//
// Design, bf16 at D = 64 and 128 (`fwd90`): one block of three
// warpgroups per (bh, 128-query tile).  Warpgroup 0 is the producer: it
// gives its registers up (setmaxnreg), and one thread issues TMA loads of
// Q once and of 128-key K and V tiles into two-stage rings in shared
// memory, with full and empty mbarriers for K and for V apart.
// Warpgroups 1 and 2 own 64 query rows each.  S = Q K^T runs as wgmma
// m64n128k16 with both operands from 128B-swizzled shared memory; the
// online softmax works on the accumulator fragments in the log2 domain
// (scale * log2(e) folded in, ex2), with the mask only on tiles that cross
// the diagonal or the ragged edge; P is rounded to bf16 in registers as
// the A operand of O += P V, V read transposed from shared memory by the
// descriptor (m64n64k16 per 64 columns of D).  The products are
// software-pipelined: one issue turn starts S_j = Q K_j^T and
// O += P_{j-1} V_{j-1}, and the softmax of S_j runs while the second is
// on the tensor cores.  The two warpgroups take their issue turns in
// alternation (named barriers), so one's softmax also overlaps the
// other's products.  The tensor maps are 3-D over [BH, T, D], so a tile
// that runs past T is zero-filled by TMA, never read from the next head;
// the host encodes them per call and passes them as __grid_constant__
// parameters.  Heads launch in groups whose K and V fit in L2, and within
// a group the heaviest (last) query tiles launch first, so the longest
// blocks do not set the tail.
//
// Other paths, chosen by dtype and D before any launch: bf16 at D = 16 and
// 32 keeps the mma.sync m16n8k16 kernel (one block per 64-query tile, four
// warps, padded shared memory, synchronous tile copies); f32 keeps full
// f32 products (no TF32), one warp per query row, plain FMA.
//
// Interface: plain C, bound with ctypes.  Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16 at D = 16 and 32: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBM = 64;             // query rows per block, 16 per warp
constexpr int kBN = 64;             // keys per K/V tile
constexpr int kWarps = kBM / 16;
constexpr int kThreads = kWarps * 32;

template <int D>
__host__ __device__ constexpr int smem_stride() { return D + 8; }  // bf16 elements per row

template <int D>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return (kBM + 2 * kBN) * smem_stride<D>() * 2;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int t, float scale, int causal) {
  constexpr int S = smem_stride<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kBM * S;
  __nv_bfloat16* sv = sk + kBN * S;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const size_t base = (size_t)bh * t * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int tg = lane & 3;  // thread in group
  const int wr = warp * 16;

  load_tile_bf16<D>(sq, q + base, q0, kBM, t);
  __syncthreads();

  // This warp's 16 query rows as A fragments, kept for the whole loop.
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p0 = sq + (wr + g) * S + kk * 16 + tg * 2;
    const __nv_bfloat16* p1 = p0 + 8 * S;
    qa[kk][0] = ld_u32(p0);
    qa[kk][1] = ld_u32(p1);
    qa[kk][2] = ld_u32(p0 + 8);
    qa[kk][3] = ld_u32(p1 + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // Index 0: query row q0 + wr + g (fragment elements 0, 1); index 1: row + 8.
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's partial sums, reduced at the end
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};

  // Causal: tiles that start past the block's last query row hold no
  // visible key and are skipped; the first tile always holds key 0, so
  // every row's running max is finite after it.
  const int kv_end = causal ? min(t, q0 + kBM) : t;
  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile_bf16<D>(sk, k + base, n0, kBN, t);
    load_tile_bf16<D>(sv, v + base, n0, kBN, t);
    __syncthreads();

    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const __nv_bfloat16* kp = sk + (j * 8 + g) * S + kk * 16 + tg * 2;
        const uint32_t b[2] = {ld_u32(kp), ld_u32(kp + 8)};
        mma_bf16(s[j], qa[kk], b);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + tg * 2 + (e & 1);
        float x = s[j][e] * scale;
        if (key >= t || (causal && key > rows[e >> 1])) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a group hold one row between them
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += P V: two score fragments (keys 16c .. 16c + 15) make one A
    // fragment; B holds V[key][d] for keys (2tg, 2tg + 1) and (+8) at d = g.
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
      const uint32_t pa[4] = {tpf::pack_bf16(s[2 * c][0], s[2 * c][1]),
                              tpf::pack_bf16(s[2 * c][2], s[2 * c][3]),
                              tpf::pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              tpf::pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vp = sv + (c * 16 + tg * 2) * S + j * 8 + g;
        const uint32_t b[2] = {pack_bf16x2(vp[0], vp[S]), pack_bf16x2(vp[8 * S], vp[9 * S])};
        mma_bf16(acc[j], pa, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const float safe_l = l_run[r] == 0.f ? 1.f : l_run[r];
    const float inv = 1.f / safe_l;
    if (rows[r] < t) {
      __nv_bfloat16* orow = o + base + (size_t)rows[r] * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tg * 2) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      }
      if (tg == 0) lse[(size_t)bh * t + rows[r]] = m_run[r] + logf(safe_l);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 64 and 128: TMA ring and warp-specialised wgmma
// ---------------------------------------------------------------------------

namespace fwd90 {

constexpr int kBM = 128;         // query rows per block, 64 per consumer warpgroup
constexpr int kBN = 128;         // keys per K/V tile
constexpr int kStages = 2;       // depth of the K and V rings
constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Shared memory: the Q tile, the K and V rings (each tile D / 64 swizzled
// boxes of [rows, 64]), then the barriers q_full, k_full[S], v_full[S],
// k_empty[S], v_empty[S]; 1024 bytes of slack align the tiles for the
// 128B swizzle.
template <int D>
struct Layout {
  static constexpr int kTileQ = kBM * D * 2;
  static constexpr int kTileKV = kBN * D * 2;
  static constexpr int kK = kTileQ;
  static constexpr int kV = kK + kStages * kTileKV;
  static constexpr int kBars = kV + kStages * kTileKV;
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int n_bh, int t, float scale, int causal,
                 int group) {
  using L = Layout<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tpf::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t q_full = base + L::kBars;
  const auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  const auto v_full = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  const auto k_empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };
  const auto v_empty = [&](int s) { return q_full + 8u * (1 + 3 * kStages + s); };
  const auto k_tile = [&](int s) { return base + L::kK + s * L::kTileKV; };
  const auto v_tile = [&](int s) { return base + L::kV + s * L::kTileKV; };

  // Heads launch in groups whose K and V stay in L2 while their blocks
  // run; within a group the heaviest (last) query tiles launch first.
  const int n_qtiles = (t + kBM - 1) / kBM;
  int bh, rank;
  tpf::grouped_tile(blockIdx.x, n_bh, n_qtiles, group, &bh, &rank);
  const int qt = n_qtiles - 1 - rank;
  const int q0 = qt * kBM;
  const int n_kv_all = (t + kBN - 1) / kBN;
  const int n_kv = causal ? min(n_kv_all, qt + 1) : n_kv_all;

  if (threadIdx.x == 0) {
    tpf::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      tpf::mbar_init(k_full(s), 1);
      tpf::mbar_init(v_full(s), 1);
      tpf::mbar_init(k_empty(s), kConsumerThreads);
      tpf::mbar_init(v_empty(s), kConsumerThreads);
    }
    tpf::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the rings full
    tpf::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tpf::mbar_arrive_expect_tx(q_full, L::kTileQ);
      for (int c = 0; c < kBoxes; ++c)
        tpf::tma_load_3d(sq + c * kBM * 128, &tq, q_full, c * 64, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        const uint32_t released = ((j / kStages) - 1) & 1;
        if (j >= kStages) tpf::mbar_wait(k_empty(s), released);
        tpf::mbar_arrive_expect_tx(k_full(s), L::kTileKV);
        for (int c = 0; c < kBoxes; ++c)
          tpf::tma_load_3d(k_tile(s) + c * kBN * 128, &tk, k_full(s), c * 64, j * kBN, bh);
        if (j >= kStages) tpf::mbar_wait(v_empty(s), released);
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
  const uint32_t q_rows = sq + wg * 64 * 128;

  float acc[kBoxes][32];
#pragma unroll
  for (int b = 0; b < kBoxes; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial sums, reduced at the end
  float corr[2] = {0.f, 0.f};   // the last softmax's rescale of acc
  uint32_t pa[kBN / 16][4];     // the last tile's P, rounded to bf16

  // S = Q K^T of ring stage s into sc
  const auto issue_s = [&](float(&sc)[64], int s) {
    tpf::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * 128 * 128 + (kk % 4) * 32;  // box kk / 4, slice kk % 4
      tpf::wgmma_m64n128_ss(sc, tpf::desc_sw128(q_rows + off),
                            tpf::desc_sw128(k_tile(s) + off), kk > 0);
    }
    tpf::wgmma_commit();
  };
  // O = O * corr + P V of ring stage s: P from registers, V transposed
  const auto issue_pv = [&](int s) {
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[b][4 * n + 0] *= corr[0];
        acc[b][4 * n + 1] *= corr[0];
        acc[b][4 * n + 2] *= corr[1];
        acc[b][4 * n + 3] *= corr[1];
      }
    }
    tpf::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
#pragma unroll
      for (int b = 0; b < kBoxes; ++b)
        tpf::wgmma_m64n64_rs_tb(acc[b], pa[c],
                                tpf::desc_sw128(v_tile(s) + b * kBN * 128 + c * 2048));
    }
    tpf::wgmma_commit();
  };
  // online softmax of the tile at key n0, in place: sc becomes P
  const auto softmax = [&](float(&sc)[64], int n0) {
    // scale, and mask only where the tile crosses the diagonal or T
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= c2;
    if ((causal && n0 + kBN - 1 > row0) || n0 + kBN > t) {
      // column 8n + e of this thread's chunk n is a visible key of row r
      // when 8n + e < limit[r]
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
    // the four threads of a quad hold one row between them
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = tpf::exp2_approx(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tpf::exp2_approx(sc[4 * n + e] - m_use[e >> 1]);
        sc[4 * n + e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
  };

  // Turn j issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}, then the softmax
  // of S_j runs while P_{j-1} V_{j-1} is on the tensor cores.  The two
  // warpgroups take turns at issuing (named barriers 1 and 2), so one's
  // softmax also overlaps the other's products; warpgroup 0 goes first.
  // The first and last turns are peeled off, so that no product is issued
  // on a path the compiler cannot prove uniform.
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) tpf::named_bar_arrive(their_turn, kConsumerThreads);
  float sc[64];
  tpf::mbar_wait(q_full, 0);
  tpf::mbar_wait(k_full(0), 0);
  tpf::named_bar_sync(my_turn, kConsumerThreads);
  issue_s(sc, 0);
  tpf::named_bar_arrive(their_turn, kConsumerThreads);
  tpf::wgmma_wait<0>();
  tpf::fence_regs(sc);
  tpf::mbar_arrive(k_empty(0));
  softmax(sc, 0);
#pragma unroll
  for (int c = 0; c < kBN / 16; ++c) tpf::pack_a(pa[c], sc, c);

  for (int j = 1; j < n_kv; ++j) {
    const int s = j % kStages;
    const int sp = (j - 1) % kStages;
    tpf::mbar_wait(k_full(s), (j / kStages) & 1);
    tpf::named_bar_sync(my_turn, kConsumerThreads);
    issue_s(sc, s);
    tpf::mbar_wait(v_full(sp), ((j - 1) / kStages) & 1);
    issue_pv(sp);
    tpf::named_bar_arrive(their_turn, kConsumerThreads);
    tpf::wgmma_wait<1>();
    tpf::fence_regs(sc);
    tpf::mbar_arrive(k_empty(s));
    softmax(sc, j * kBN);
    tpf::wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) tpf::fence_regs(acc[b]);
    tpf::mbar_arrive(v_empty(sp));
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) tpf::pack_a(pa[c], sc, c);
  }

  {
    const int sp = (n_kv - 1) % kStages;
    tpf::named_bar_sync(my_turn, kConsumerThreads);
    tpf::mbar_wait(v_full(sp), ((n_kv - 1) / kStages) & 1);
    issue_pv(sp);
    // warpgroup 1's last arrival has no follower; it is left on barrier 1
    // when the block exits (a branch around it would serialize the products)
    tpf::named_bar_arrive(their_turn, kConsumerThreads);
    tpf::wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) tpf::fence_regs(acc[b]);
    tpf::mbar_arrive(v_empty(sp));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float safe_l = l == 0.f ? 1.f : l;
    const float inv = 1.f / safe_l;
    if (rows[r] < t) {
      __nv_bfloat16* orow = o + ((size_t)bh * t + rows[r]) * D;
#pragma unroll
      for (int b = 0; b < kBoxes; ++b) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * b + 8 * n + col) =
              __floats2bfloat162_rn(acc[b][4 * n + 2 * r] * inv, acc[b][4 * n + 2 * r + 1] * inv);
        }
      }
      if (lane % 4 == 0) lse[(size_t)bh * t + rows[r]] = m_run[r] * 0.6931471805599453f + logf(safe_l);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int t,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = tpf::tensor_map_bf16(&tq, q, bh, t, D, kBM);
  if (err == cudaSuccess) err = tpf::tensor_map_bf16(&tk, k, bh, t, D, kBN);
  if (err == cudaSuccess) err = tpf::tensor_map_bf16(&tv, v, bh, t, D, kBN);
  if (err != cudaSuccess) return err;
  constexpr int bytes = Layout<D>::kBytes;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (t + kBM - 1) / kBM * bh;
  flash_fwd_kernel<D><<<blocks, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), bh, t, scale, causal,
      tpf::heads_per_group(bh, t, D));
  return cudaGetLastError();
}

}  // namespace fwd90

// ---------------------------------------------------------------------------
// f32: full-precision FMA, one warp per query row, one key per lane
// ---------------------------------------------------------------------------

constexpr int kRowsF = 16;  // query rows (warps) per block
constexpr int kKeysF = 32;  // keys per K/V tile, one per lane

template <int D>
__global__ void __launch_bounds__(kRowsF * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int t, float scale, int causal) {
  constexpr int kPerLane = (D + 31) / 32;  // output columns a lane owns
  __shared__ float sq[kRowsF][D];
  __shared__ float sk[kKeysF][D + 1];  // +1: lane j reads row j without conflicts
  __shared__ float sv[kKeysF][D];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowsF;
  const size_t base = (size_t)bh * t * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = q0 + warp;

  for (int i = threadIdx.x; i < kRowsF * D; i += kRowsF * 32) {
    const int r = i / D, c = i % D;
    sq[r][c] = (q0 + r < t) ? q[base + (size_t)(q0 + r) * D + c] : 0.f;
  }

  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
  float m_run = kNegInf, l_run = 0.f;

  const int kv_end = causal ? min(t, q0 + kRowsF) : t;
  for (int n0 = 0; n0 < kv_end; n0 += kKeysF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKeysF * D; i += kRowsF * 32) {
      const int r = i / D, c = i % D;
      const bool in = n0 + r < t;
      sk[r][c] = in ? k[base + (size_t)(n0 + r) * D + c] : 0.f;
      sv[r][c] = in ? v[base + (size_t)(n0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    const int key = n0 + lane;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(sq[warp][d], sk[lane][d], s);
    s *= scale;
    if (key >= t || (causal && key > row)) s = kNegInf;
    const float m_new = fmaxf(m_run, warp_max(s));
    const float corr = expf(m_run - m_new);
    const float p = expf(s - m_new);
    l_run = l_run * corr + warp_sum(p);
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] *= corr;
    for (int j = 0; j < kKeysF; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pj, sv[j][d], acc[i]);
      }
    }
  }

  if (row < t) {
    const float safe_l = l_run == 0.f ? 1.f : l_run;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[base + (size_t)row * D + d] = acc[i] / safe_l;
    }
    if (lane == 0) lse[(size_t)bh * t + row] = m_run + logf(safe_l);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        int bh, int t, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBM - 1) / kBM, bh);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), t, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int t, float scale, int causal, cudaStream_t stream) {
  const dim3 grid((t + kRowsF - 1) / kRowsF, bh);
  flash_fwd_f32_kernel<D><<<grid, kRowsF * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), t, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [bh, t, d] contiguous, 16-byte aligned; lse: [bh, t] f32.
// dtype: 0 = float32, 1 = bfloat16.  d: 16, 32, 64 or 128.
extern "C" int tpf_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int bh, int t, int d, float scale, int causal, int dtype,
                                  void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPF_CASE(DIM, FN) \
  case DIM:               \
    return static_cast<int>(FN<DIM>(q, k, v, o, lse, bh, t, scale, causal, s));
  if (dtype == 1) {
    switch (d) {
      TPF_CASE(16, launch_bf16)
      TPF_CASE(32, launch_bf16)
      TPF_CASE(64, fwd90::launch)
      TPF_CASE(128, fwd90::launch)
      default:
        break;
    }
  } else if (dtype == 0) {
    switch (d) {
      TPF_CASE(16, launch_f32)
      TPF_CASE(32, launch_f32)
      TPF_CASE(64, launch_f32)
      TPF_CASE(128, launch_f32)
      default:
        break;
    }
  }
#undef TPF_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block of the bf16 kernel at head dim d, in
// bytes; -1 for a head dim it does not take.
extern "C" int tpf_flash_attn_fwd_smem(int d) {
  switch (d) {
    case 16: return bf16_smem_bytes<16>();
    case 32: return bf16_smem_bytes<32>();
    case 64: return fwd90::Layout<64>::kBytes;
    case 128: return fwd90::Layout<128>::kBytes;
    default: return -1;
  }
}

// Host nanoseconds of one tensor-map encode, the mean of `reps` encodes of
// a [bh, t, d] bf16 map over `ptr` after one to warm up (host work only;
// nothing is launched); -1 when the encode fails.  A bf16 launch at
// D = 64 or 128 encodes three maps (forward) or four (dQ, dK/dV).
extern "C" int tpf_tensor_map_encode_ns(const void* ptr, int bh, int t, int d, int reps) {
  CUtensorMap map;
  if (reps <= 0 || tpf::tensor_map_bf16(&map, ptr, bh, t, d, fwd90::kBN) != cudaSuccess) return -1;
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) tpf::tensor_map_bf16(&map, ptr, bh, t, d, fwd90::kBN);
  const auto ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                      std::chrono::steady_clock::now() - start)
                      .count();
  return static_cast<int>(ns / reps);
}
