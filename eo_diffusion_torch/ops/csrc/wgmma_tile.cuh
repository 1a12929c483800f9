// Warpgroup primitives for Hopper (sm_90a) kernels: mbarriers, TMA tile loads,
// named barriers, register reallocation, and wgmma with its shared-memory
// descriptors and f32 accumulators, the scaling of a tile in shared memory,
// and on the host the 4-D tensor map of a strided [B, T, H, D] plane. The
// attention forward (attention_fwd_sm90.cu) and backward
// (attention_bwd_sm90.cu) are built on them; the GroupNorm kernels
// (group_norm_sm90.cu) use the mbarriers, the 1-D bulk copies and the L2
// eviction policies.
//
// Operand tiles in shared memory. Every tile is stored the way a TMA load with
// a swizzle of AW * 2 bytes (AW = 64, 32 or 16 bf16: CU_TENSOR_MAP_SWIZZLE_
// 128B, 64B, 32B) leaves it: rows of AW bf16, the 16-byte pieces of row r
// XOR-permuted by r, so 8 rows make a swizzle atom of 16 AW bytes. A matrix
// wider than AW columns is several such column blocks ("chunks") one after
// the other, chunk c of an R-row tile at c * R * AW * 2 bytes, each on a
// multiple of 16 AW bytes. wgmma then reads a chunked tile in two ways:
//   * K-major (the contraction index along the columns: Q and K in QK^T):
//     SBO = 16 AW (the next 8 rows), LBO unused; the k16 slice kk of a chunk
//     starts kk * 32 bytes into its rows, the next chunk R * AW * 2 on;
//   * MN-major (the contraction index down the rows: V in PV): SBO = 16 AW
//     (the next 8 rows of the contraction), LBO = R * AW * 2 (the next AW
//     columns); the k16 slice kk starts kk * 32 AW bytes on.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace eo_wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// one arrival that also expects `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed (phases count from 0)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completes `bytes` of the box's size on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes of global memory into shared memory (both 16-byte
// aligned, `bytes` a multiple of 16); completes `bytes` on `bar`. No tensor
// map: a range of whole rows of a channels-last tensor is one such copy
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the same with an L2 eviction policy (createpolicy), e.g. evict-first for
// bytes read once
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint64_t l2_evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// 16, 8 or 4 bytes of global memory under an L2 eviction policy
__device__ __forceinline__ uint4 ld_global_hint(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ uint2 ld_global_hint(const uint2* p, uint64_t policy) {
  uint2 v;
  asm volatile("ld.global.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ unsigned int ld_global_hint(const unsigned int* p, uint64_t policy) {
  unsigned int v;
  asm volatile("ld.global.L2::cache_hint.u32 %0, [%1], %2;\n" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ unsigned short ld_global_hint(const unsigned short* p,
                                                         uint64_t policy) {
  unsigned short v;
  asm volatile("ld.global.L2::cache_hint.u16 %0, [%1], %2;\n" : "=h"(v) : "l"(p), "l"(policy));
  return v;
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma reads, TMA writes) of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- warp specialisation -------------------------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// named barrier `id` (1-15) over `n` threads: wait, or only arrive
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// descriptor of a swizzled operand starting at `p` (see the top): rows of
// AW bf16 (AW * 2 bytes, swizzled over as many), 8-row atoms
template <int AW>
__device__ __forceinline__ uint64_t desc_sw(const void* p, uint32_t lbo_bytes,
                                            uint32_t sbo_bytes) {
  static_assert(AW == 64 || AW == 32 || AW == 16, "swizzle spans of 128, 64 or 32 bytes");
  constexpr uint64_t layout = AW == 64 ? 1 : AW == 32 ? 2 : 3;
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products that read or write them
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The accumulator of an m64nN product: thread t of the warpgroup holds, for
// each n8 block j, d[4j + 0..1] at row 16 (t / 32) + (t % 32) / 4, columns
// 8j + 2 (t % 4) + {0, 1}, and d[4j + 2..3] at the row 8 below. The A
// register fragment of an m64nNk16 product is laid out the same way for one
// k16 slice (a[0]: row r, k 2 (t % 4) + {0, 1}; a[1]: row r + 8; a[2], a[3]:
// k + 8), so an accumulator packed to bf16 pairs is the next product's A.

#define EO_ACC8(i)                                                                           \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d[32] (+)= A (64 x 16, K-major in shared memory) * B (16 x 64, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : EO_ACC8(0), EO_ACC8(8), EO_ACC8(16), EO_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[16] (+)= A (64 x 16, K-major in shared memory) * B (16 x 32, K-major)
__device__ __forceinline__ void wgmma_m64n32k16_ss(float* d, uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : EO_ACC8(0), EO_ACC8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (+)= A (64 x 16, K-major in shared memory) * B (16 x 128, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : EO_ACC8(0), EO_ACC8(8), EO_ACC8(16), EO_ACC8(24), EO_ACC8(32), EO_ACC8(40),
        EO_ACC8(48), EO_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] (+)= A (64 x 16 bf16 in registers, a[4]) * B (16 x 64, MN-major in
// shared memory)
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float* d, const uint32_t (&a)[4],
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : EO_ACC8(0), EO_ACC8(8), EO_ACC8(16), EO_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[32] (+)= A (64 x 16 bf16 in registers, a[4]) * B (16 x 64, K-major in
// shared memory)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : EO_ACC8(0), EO_ACC8(8), EO_ACC8(16), EO_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[24] (+)= A (64 x 16 bf16 in registers, a[4]) * B (16 x 48, MN-major in
// shared memory)
__device__ __forceinline__ void wgmma_m64n48k16_rs_mn(float* d, const uint32_t (&a)[4],
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : EO_ACC8(0), EO_ACC8(8), EO_ACC8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef EO_ACC8

// ---- tiles in shared memory ----------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void scale8(uint4& v, __nv_bfloat162 s2) {
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = __hmul2(e[k], s2);
}

// x * s rounded to bf16 over `chunks` 16-byte pieces of a tile, piece i by
// thread i % n, four pieces in flight a thread
__device__ __forceinline__ void scale_tile(__nv_bfloat16* tile, int chunks, int i, int n,
                                           __nv_bfloat162 s2) {
  constexpr int U = 4;
  uint4* p = reinterpret_cast<uint4*>(tile);
  for (; i + (U - 1) * n < chunks; i += U * n) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = p[i + u * n];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      scale8(v[u], s2);
      p[i + u * n] = v[u];
    }
  }
  for (; i < chunks; i += n) {
    uint4 v = p[i];
    scale8(v, s2);
    p[i] = v;
  }
}

// ---- tensor maps (host) ----------------------------------------------------

// element (b, t, h, d) of a [B, T, H, D] operand at ptr + b*sb + t*st + h*sh + d
struct Plane {
  const void* ptr;
  long long sb, st, sh;
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (no link against libcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (D, T, H, B) view of a bf16 plane, boxes of AW columns x `rows` tokens,
// swizzled over AW * 2 bytes; columns past D and rows past T read as zeros.
// A stride of an axis of extent 1 is never stepped; it only has to be valid.
inline bool encode_plane(CUtensorMap* map, const Plane& pl, int B, int T, int H, int D, int aw,
                         int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const long long st[3] = {pl.st, pl.sh, pl.sb};
  const int ext[3] = {T, H, B};
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    if (st[i] < 0 || st[i] % 8 != 0) return false;
    strides[i] = (cuuint64_t)(ext[i] == 1 && st[i] == 0 ? 8 : st[i]) * 2;
  }
  cuuint32_t box[4] = {(cuuint32_t)aw, (cuuint32_t)rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = aw == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : aw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(pl.ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace eo_wg
