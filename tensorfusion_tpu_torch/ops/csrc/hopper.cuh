// Hopper (sm_90a) building blocks shared by the flash-attention kernels,
// in raw inline PTX: tensor maps and TMA tile loads, mbarriers, wgmma
// descriptors and products, register rebalancing.  No CuTe, no -lcuda:
// cuTensorMapEncodeTiled is looked up at run time through the CUDA
// runtime (cudaGetDriverEntryPoint).
//
// Layout contract between TMA and wgmma used by every kernel here: a bf16
// tile of R rows and D columns (D = 64 or 128) is loaded as D / 64 boxes of
// [R rows, 64 columns] with the 128-byte swizzle, box c at byte offset
// c * R * 128 of the tile, each row 128 bytes, the tile 1024-byte aligned.
// Such a box is, for wgmma, a canonical 128B-swizzled operand either way:
// - K-major (rows are M or N, columns the depth): stride between 8-row
//   groups (SBO) 1024 bytes; the k16 slice kk of a box starts kk * 32 bytes
//   into it (the hardware applies the swizzle to the computed address);
// - MN-major (rows are the depth, columns are N, "transposed" B): eight
//   depth rows of 128 bytes make one 1024-byte atom, SBO = 1024 between
//   atoms; the k16 slice kk starts kk * 2048 bytes into the box; one box
//   spans N = 64, so such products are issued 64 columns at a time.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only, nothing linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tpf {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A [bh, t, d] bf16 tensor (d = 64 or 128, rows d * 2 bytes apart) as a 3-D
// tensor map with [box_rows, 64]-column boxes and the 128-byte swizzle.
// Being 3-D, a box that runs past row t of one head is zero-filled by the
// hardware rather than read from the next head.
inline cudaError_t tensor_map_bf16(CUtensorMap* map, const void* ptr, int bh, int t, int d,
                                   int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64u, (cuuint32_t)box_rows, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Heads per launch group of grouped_tile(): as many as keep the streamed
// operands (two [t, d] bf16 tiles a head) within about 16 MB of L2.
inline int heads_per_group(int bh, int t, int d) {
  const long long per_head = 4LL * t * d;
  const long long g = (16LL << 20) / per_head;
  return (int)(g < 1 ? 1 : (g > bh ? bh : g));
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A barrier starts
// in phase 0, so waiting on parity 1 of a fresh barrier returns at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map at element coordinates (c0 innermost) into
// shared memory; completes `bytes` of the transaction count on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The (head, tile rank) of block `linear` of a 1-D grid of bh * n_tiles
// blocks launched in order: heads go in groups of `group` (the blocks in
// flight share their group's streamed operands in L2), and within a group
// rank 0 of every head launches first, then rank 1, and so on, so that
// the heaviest tiles start first.
__device__ __forceinline__ void grouped_tile(int linear, int bh, int n_tiles, int group,
                                             int* head, int* rank) {
  const int first = linear / (group * n_tiles) * group;
  const int heads = min(group, bh - first);
  const int r = linear - first * n_tiles;
  *head = first + r % heads;
  *rank = r / heads;
}

// ---------------------------------------------------------------------------
// device: warpgroup roles
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads:
// sync waits for all of them, arrive counts this warp in and goes on.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128B-swizzled operand (see the
// layout contract above): start address >> 4, leading byte offset 1 (not
// read for these layouts), stride byte offset 1024 >> 4, swizzle mode 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous product (no instruction is emitted).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64nNk16 (f32), thread t of the warpgroup, warp
// w = t / 32, lane l: d[4n + 2i + j] holds row 16w + l/4 + 8i and column
// 8n + 2(l%4) + j.  The A fragment from registers has mma.sync's m16k16
// layout per warp, so two accumulator chunks n = 2c, 2c + 1 rounded to
// bf16 pairs make the A fragment of depth slice c (pack_a below).

#define TPF_R8(d, i)                                                                     \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TPF_R32(d) TPF_R8(d, 0), TPF_R8(d, 8), TPF_R8(d, 16), TPF_R8(d, 24)
#define TPF_R64(d) TPF_R32(d), TPF_R8(d, 32), TPF_R8(d, 40), TPF_R8(d, 48), TPF_R8(d, 56)

#define TPF_D32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define TPF_D64                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "

// d (+)= A B, m64n128k16, A K-major and B K-major from shared memory.
// accumulate = 0 ignores d's old value.
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TPF_D64
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : TPF_R64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n64k16, A K-major and B K-major from shared memory.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TPF_D32
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : TPF_R32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers (bf16 pairs), B MN-major
// ("transposed") from shared memory.
__device__ __forceinline__ void wgmma_m64n64_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TPF_D32
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TPF_R32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef TPF_R8
#undef TPF_R32
#undef TPF_R64
#undef TPF_D32
#undef TPF_D64

// Two floats rounded to bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator columns [16c, 16c + 16) rounded to bf16 as the A fragment of
// depth slice c of the next product.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N], int c) {
  a[0] = pack_bf16(d[8 * c + 0], d[8 * c + 1]);
  a[1] = pack_bf16(d[8 * c + 2], d[8 * c + 3]);
  a[2] = pack_bf16(d[8 * c + 4], d[8 * c + 5]);
  a[3] = pack_bf16(d[8 * c + 6], d[8 * c + 7]);
}

// 2^x in one MUFU instruction; 2^-inf = +0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace tpf
