// Tensor-core tile primitives for Hopper (sm_90a) shared by the port's GEMM-shaped
// kernels (conv_wgrad.cu, attn_probes.cu, attn_variants.cu): 16-byte cp.async
// copies with zero fill, ldmatrix fragment loads in both storage orders, the
// m16n8k16 bf16 mma.sync with f32 accumulators, and the two scalar helpers of
// the attention kernels (ex2, bf16 pair packing).
//
// Storage orders. A product C[M, N] += A[M, K] B[K, N] takes A as a 16 x 16
// (m x k) fragment and B as a 16 x 8 (k x n) fragment. An operand tile in
// shared memory is stored either with its contraction index along the row
// ("k inner": A as [m][k], B as [n][k]) or across rows ("k outer": A as
// [k][m], B as [k][n]). k inner is what mma.sync's row.col operands want and
// takes plain ldmatrix; k outer takes ldmatrix.trans, which hands each
// thread the transposed 8 x 8 piece, so neither order needs a transpose in
// shared memory. Every row address must be 16-byte aligned; a row stride of
// 8 elements past a multiple of 64 (e.g. 72 or 40) puts the 8 rows of an
// ldmatrix piece in 8 distinct 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace eo_tile {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; zero-fills the 16 bytes when !in
// (src is then not read but must be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// 2^x on the special-function unit (flush-to-zero; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 in one 32-bit register, lo in the low half (the
// smaller k or n index of a fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[4] += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 accumulators.
// c[0], c[1]: row g, columns 2t, 2t + 1; c[2], c[3]: row g + 8 (g = lane / 4,
// t = lane % 4).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (m 16 x k 16) whose element (m0, k0) sits at `base`, rows
// `ld` elements apart. K_OUTER: stored [k][m]; else stored [m][k]. Lane l
// addresses row l % 8 of piece l / 8; the pieces are (m 0-7, k 0-7), (m 8-15,
// k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15), the order of a[0..3].
template <bool K_OUTER>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* base, int ld,
                                       int lane) {
  const int j = lane >> 3, r = lane & 7;
  const int mo = (j & 1) * 8, ko = (j >> 1) * 8;
  if (K_OUTER)
    ldsm_x4_trans(a, base + (ko + r) * ld + mo);
  else
    ldsm_x4(a, base + (mo + r) * ld + ko);
}

// Two B fragments (k 16 x n 8 each, for n0 and n0 + 8) whose element (k0, n0)
// sits at `base`. K_OUTER: stored [k][n]; else stored [n][k]. The pieces
// are (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15):
// b[0] = {piece 0, piece 1}, b[1] = {piece 2, piece 3}.
template <bool K_OUTER>
__device__ __forceinline__ void load_b2(uint32_t (&b)[2][2], const __nv_bfloat16* base, int ld,
                                        int lane) {
  const int j = lane >> 3, r = lane & 7;
  const int ko = (j & 1) * 8, no = (j >> 1) * 8;
  uint32_t q[4];
  if (K_OUTER)
    ldsm_x4_trans(q, base + (ko + r) * ld + no);
  else
    ldsm_x4(q, base + (no + r) * ld + ko);
  b[0][0] = q[0];
  b[0][1] = q[1];
  b[1][0] = q[2];
  b[1][1] = q[3];
}

}  // namespace eo_tile
