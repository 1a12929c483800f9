// Self-attention forward for Hopper (sm_90a) on mma.sync, bound through
// ctypes: the port's first attention body, and its float32 kernel.
//
// Since the wgmma/TMA body (attention_fwd_sm90.cu) took every bf16 launch of
// the model paths, this file's entries carry the suffix _mma: through them
// bf16 runs the mma.sync body below, which no model path calls and which the
// attention probes (attn_variants.cu, attn_probes.cu) copy and time as their
// yardstick, and float32 runs the FMA kernel, which the wrappers still route
// every float32 forward to (ops/attention.py, fwd_route).
//
// Replaces three TPU kernels, which compute one function on three layouts:
//   * `_qkv_layout_kernel_tpv` / `_qkv_layout_kernel` (K1,
//     eo_diffusion_tpu/ops/attention.py:738 / :697, launched by
//     `_qkv5_fwd_impl` at :797): q, k, v read from the fused projection;
//   * `_resident_kernel` (K2, :271) and `_flash_kernel` (K3, :227), the
//     resident and grid-tiled branches of `_flash_fwd_impl` (:333), which
//     run `flash_attention` on folded [B*H, T, D_pad] copies of q, k and v.
// It computes the same function, not the same block structure:
//
//   o = softmax((q*s) (k*s)^T) v,   s = D^-1/4 rounded to the input dtype.
//
// q, k and v are three strided planes: element (b, t, h, d) of a plane
// sits at ptr + b*sb + t*st + h*sh + d. The fused projection qkv [B, T, 3C]
// is one such case (the three planes of one tensor at channel offsets of
// either head order; entry `eo_qkv_attention_fwd`), three separate
// [B, T, H, D] tensors or views of them another (`eo_attention_fwd`), so
// one kernel body serves K1, K2 and K3 and nothing is copied or padded. On
// Hopper there is no VMEM residency to split on: K/V always stream through
// shared memory, so one design covers K2's T <= 4096 and K3's longer T.
// o is written as [B, T, H, D] contiguous, which is [B, T, C] with channel
// h*D + d, the layout the block's proj_out reads. Scores, the
// running max m, the running sum l and the output accumulator are f32
// (online softmax over K/V tiles, normalized once at the end). p is rounded
// to the input dtype before the PV product, like `p.astype(v.dtype)` in the
// TPU kernel. Optionally it writes the row logsumexp lse = m + log(l) as
// [B*H, T] f32, which the flash backward reads. A row whose sum l is 0 (no
// key: not reached by self-attention, which always has one) gives o = 0 and
// lse = +0.7*FLT_MAX, as the TPU kernels do (attention.py:267, :311, :316).
//
// What bounds it on the H100: at the clouds UNet's ds-4 shape (B 8, T 4096,
// C 384, 8 heads of D 48) one launch is 4*T^2*C*B = 206 GFLOP against about
// 100 MB of q/k/v/o traffic, about 2000 FLOP per byte, far above the card's
// ~295 FLOP/byte ridge: it is compute-bound, and the lower bound is the bf16
// tensor-core rate (206 GFLOP / 989 TFLOP/s = 0.21 ms). Besides the tensor
// cores, each score costs one exponential (the special-function units do 16
// a cycle per SM, a floor of about 0.28 ms at ds 4) and each product reads
// its B fragment from shared memory. The design therefore keeps all matrix
// work on the tensor cores, the T x T scores out of memory and the shared-
// memory traffic per product low:
//   * one CTA of 4 warps per (batch*head, q tile); each warp owns 32 query
//     rows (two m16 tiles; 16 for D > 64, where registers run out) whose q
//     fragments stay in registers for the whole KV sweep, so every K and V
//     fragment read from shared memory feeds two products;
//   * K/V tiles of 64 keys stream through a two-stage cp.async ring in
//     shared memory (rows padded by 16 B so the fragment loads hit 32
//     distinct banks): tile k+1 is in flight while tile k is computed. Each
//     K/V byte is read from device memory once per q tile, and the q tiles
//     of one head run next to each other, so those re-reads mostly hit L2;
//   * QK^T and PV run as mma.sync m16n8k16 bf16 tiles with f32 accumulators;
//     the score accumulator is re-packed in registers as the A operand of PV
//     (no trip through shared memory), and D = 48 is three k16 slices, so the
//     clouds head dim needs no padding;
//   * the softmax runs in base 2 (one FFMA and one ex2 per score);
//   * the ragged tail of T is masked (keys to -inf, rows not stored).
// wgmma, TMA and warp specialisation are attention_fwd_sm90.cu's.
//
// The float32 path (--no_bf16) is a plain FMA kernel in the same file: one
// thread per query row, K/V tiles in shared memory, an online softmax that
// updates per key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;           // keys per K/V tile (bf16 kernel)
constexpr int kF32Rows = 128;     // query rows per CTA (f32 kernel), one per thread
constexpr int kF32BK = 32;        // keys per K/V tile (f32 kernel)
constexpr float kFullyMaskedLse = 0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;

// bf16 kernel tiling for head dims padded to DP (a multiple of 16)
template <int DP>
struct Tiling {
  static constexpr int LD = DP + 8;            // +16 B per row: conflict-free fragment loads
  static constexpr int MT = DP <= 64 ? 2 : 1;  // m16 query tiles per warp
  static constexpr int BQ = 16 * MT * kWarps;  // query rows per CTA
  static constexpr int kStage = 2 * kBK * LD;  // one K tile + one V tile, elements
  static constexpr int kSmemBytes = 2 * kStage * 2;  // two stages of bf16
  static_assert(BQ <= 2 * kBK, "the q tile is staged in one K/V stage");
};

// element (b, t, h, d) of a [B, T, H, D] operand at ptr + b*sb + t*st + h*sh + d
struct Plane {
  const void* ptr;
  long long sb, st, sh;
};

struct Params {
  Plane q, k, v;
  void* out;  // [B, T, H, D] contiguous
  float* lse;
  int T, H, D, C;
  float scale;
};

// row t = 0 of head h of batch b
template <typename E>
__device__ __forceinline__ const E* plane_at(const Plane& pl, int b, int h) {
  return static_cast<const E*>(pl.ptr) + (long long)b * pl.sb + (long long)h * pl.sh;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B operand (k16 x n8) of the PV product from V rows [key][d] in shared memory
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const __nv_bfloat16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// 16-byte asynchronous copy to shared memory; zero-fills when !in
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool in) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x * s rounded to bf16, for 8 packed values (one rounding, like q * s in bf16)
__device__ __forceinline__ void scale8(uint4& v, __nv_bfloat162 s2) {
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = __hmul2(e[k], s2);
}

// Issue the copies of keys [k0, k0 + kBK) of the K and V planes into one
// stage (rows >= T and columns >= D zero-filled). D % 8 == 0, so a 16-byte
// chunk is all in or all out. K and V share a token stride (run() checks),
// so a V row sits off_v elements from its K row: one row address serves
// both copies, which keeps the copy loop as short as the fused-qkv
// kernel's was (a second row product cost K1 6-7 % at D 48).
template <int DP>
__device__ __forceinline__ void issue_kv(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                         const __nv_bfloat16* kp, long long off_v,
                                         long long stride_t, int k0, int T, int D) {
  constexpr int LD = Tiling<DP>::LD;
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int d = (i % kChunks) * 8;
    const bool in = k0 + r < T && d < D;
    const __nv_bfloat16* row = kp + (in ? (long long)(k0 + r) * stride_t + d : 0);
    cp_async16(sK + r * LD + d, row, in);
    cp_async16(sV + r * LD + d, row + (in ? off_v : 0), in);
  }
}

// k * s in place for the K chunks this thread copied (same indexing as
// issue_kv); the copies are visible to the issuing thread after the wait
template <int DP>
__device__ __forceinline__ void scale_k(__nv_bfloat16* sK, __nv_bfloat162 s2) {
  constexpr int LD = Tiling<DP>::LD;
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    uint4* ptr = reinterpret_cast<uint4*>(sK + (i / kChunks) * LD + (i % kChunks) * 8);
    uint4 v = *ptr;
    scale8(v, s2);
    *ptr = v;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) attn_fwd_bf16(Params p) {
  using Tl = Tiling<DP>;
  constexpr int LD = Tl::LD;
  constexpr int MT = Tl::MT;
  constexpr int KS = DP / 16;  // k16 slices of the head dim
  constexpr int NT = DP / 8;   // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * Tl::BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread within the group
  const __nv_bfloat16* kp = plane_at<__nv_bfloat16>(p.k, b, h);
  const long long off_v = (reinterpret_cast<intptr_t>(plane_at<__nv_bfloat16>(p.v, b, h)) -
                           reinterpret_cast<intptr_t>(kp)) / 2;
  const __nv_bfloat162 s2 = __float2bfloat162_rn(p.scale);
  const int n_tiles = (p.T + kBK - 1) / kBK;

  // K/V tile 0 -> stage 0 in flight while q is staged through stage 1
  issue_kv<DP>(smem, smem + kBK * LD, kp, off_v, p.k.st, 0, p.T, p.D);
  cp_async_commit();
  {
    __nv_bfloat16* sQ = smem + Tl::kStage;
    constexpr int kChunks = DP / 8;
    const __nv_bfloat16* qp = plane_at<__nv_bfloat16>(p.q, b, h);
    for (int i = threadIdx.x; i < Tl::BQ * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int d = (i % kChunks) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < p.T && d < p.D) {
        v = *reinterpret_cast<const uint4*>(qp + (long long)(q0 + r) * p.q.st + d);
        scale8(v, s2);
      }
      *reinterpret_cast<uint4*>(sQ + r * LD + d) = v;
    }
  }
  __syncthreads();
  uint32_t qa[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const __nv_bfloat16* r0 = smem + Tl::kStage + ((warp * MT + mt) * 16 + g) * LD + tq * 2;
    const __nv_bfloat16* r1 = r0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[mt][kk][0] = ld_u32(r0 + kk * 16);
      qa[mt][kk][1] = ld_u32(r1 + kk * 16);
      qa[mt][kk][2] = ld_u32(r0 + kk * 16 + 8);
      qa[mt][kk][3] = ld_u32(r1 + kk * 16 + 8);
    }
  }
  __syncthreads();  // stage 1 is free for K/V tile 1

  float o[MT][NT][4];
  float m[MT][2], l[MT][2];  // rows g and g + 8 of each m16 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    __nv_bfloat16* sK = smem + (kt & 1) * Tl::kStage;
    __nv_bfloat16* sV = sK + kBK * LD;
    if (kt + 1 < n_tiles) {
      __nv_bfloat16* nK = smem + ((kt + 1) & 1) * Tl::kStage;
      issue_kv<DP>(nK, nK + kBK * LD, kp, off_v, p.k.st, (kt + 1) * kBK, p.T, p.D);
    }
    cp_async_commit();  // possibly empty: keeps one group per tile
    cp_async_wait_1();  // tile kt has landed
    scale_k<DP>(sK, s2);
    __syncthreads();

    // S = (q s)(k s)^T for MT x 16 rows x 64 keys per warp; each K fragment
    // feeds MT products
    const int k0 = kt * kBK;
    float s[MT][kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
      const __nv_bfloat16* kr = sK + (n * 8 + g) * LD + tq * 2;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t b0 = ld_u32(kr + kk * 16);
        const uint32_t b1 = ld_u32(kr + kk * 16 + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(s[mt][n], qa[mt][kk], b0, b1);
      }
    }
    if (k0 + kBK > p.T) {  // ragged tail: keys past T never win
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + n * 8 + tq * 2 + (e & 1) >= p.T) s[mt][n][e] = -INFINITY;
    }

    // online softmax in f32, base 2; the 4 threads of a group share a row
    uint32_t pa[MT][kBK / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      float rs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[mt][r], mx[r]);
        const float alpha = ex2((m[mt][r] - mn) * kLog2e);  // 0 on the first tile
        m[mt][r] = mn;
        l[mt][r] *= alpha;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[mt][n][2 * r] *= alpha;
          o[mt][n][2 * r + 1] *= alpha;
        }
        const float mb = mn * kLog2e;
        rs[r] = 0.f;
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n) {
          s[mt][n][2 * r] = ex2(fmaf(s[mt][n][2 * r], kLog2e, -mb));
          s[mt][n][2 * r + 1] = ex2(fmaf(s[mt][n][2 * r + 1], kLog2e, -mb));
          rs[r] += s[mt][n][2 * r] + s[mt][n][2 * r + 1];
        }
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[mt][r] += rs[r];
      }
      // two n8 score tiles make one k16 A fragment of P (p rounded to bf16)
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        pa[mt][j][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
        pa[mt][j][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
        pa[mt][j][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
        pa[mt][j][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
      }
    }

    // O += P V; each V fragment feeds MT products
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const __nv_bfloat16* vr = sV + (j * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, vr + n * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(o[mt][n], pa[mt][j], b0, b1);
      }
    }
    __syncthreads();  // stage kt & 1 is refilled with tile kt + 2 next
  }

  // epilogue: normalize once, write [B, T, C] at channel h*D + d
  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(p.out) + (long long)b * p.T * p.C + (long long)h * p.D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + (warp * MT + mt) * 16 + g + 8 * r;
      if (row >= p.T) continue;
      const float inv = l[mt][r] == 0.f ? 0.f : 1.f / l[mt][r];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = n * 8 + tq * 2;
        if (d < p.D)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * p.C + d) =
              __floats2bfloat162_rn(o[mt][n][2 * r] * inv, o[mt][n][2 * r + 1] * inv);
      }
      if (p.lse != nullptr && tq == 0)
        p.lse[(long long)bh * p.T + row] =
            l[mt][r] == 0.f ? kFullyMaskedLse : m[mt][r] + logf(l[mt][r]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kF32Rows) attn_fwd_f32(Params p) {
  __shared__ __align__(16) float sK[kF32BK][DP];
  __shared__ __align__(16) float sV[kF32BK][DP];

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int row = blockIdx.x * kF32Rows + threadIdx.x;
  const float* qp = plane_at<float>(p.q, b, h);
  const float* kp = plane_at<float>(p.k, b, h);
  const float* vp = plane_at<float>(p.v, b, h);

  float q[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    q[d] = (row < p.T && d < p.D) ? qp[(long long)row * p.q.st + d] * p.scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int n_tiles = (p.T + kF32BK - 1) / kF32BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32BK;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BK * (DP / 4); i += kF32Rows) {
      const int r = i / (DP / 4);
      const int d = (i % (DP / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < p.T && d < p.D) {
        kv = *reinterpret_cast<const float4*>(kp + (long long)(k0 + r) * p.k.st + d);
        vv = *reinterpret_cast<const float4*>(vp + (long long)(k0 + r) * p.v.st + d);
        kv.x *= p.scale; kv.y *= p.scale; kv.z *= p.scale; kv.w *= p.scale;
      }
      *reinterpret_cast<float4*>(&sK[r][d]) = kv;
      *reinterpret_cast<float4*>(&sV[r][d]) = vv;
    }
    __syncthreads();

    // per-key online softmax: rescale only when the running max grows
#pragma unroll 1
    for (int j = 0; j < kF32BK && k0 + j < p.T; ++j) {
      float sj = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) sj = fmaf(q[d], sK[j][d], sj);
      if (sj > m) {
        const float alpha = expf(m - sj);  // 0 while m = -inf
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DP; ++d) acc[d] *= alpha;
        m = sj;
      }
      const float pj = expf(sj - m);
      l += pj;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(pj, sV[j][d], acc[d]);
    }
  }

  if (row < p.T) {
    float* out = static_cast<float*>(p.out) + ((long long)b * p.T + row) * p.C +
                 (long long)h * p.D;
#pragma unroll
    const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < p.D) out[d] = acc[d] * inv;
    if (p.lse != nullptr)
      p.lse[(long long)bh * p.T + row] = l == 0.f ? kFullyMaskedLse : m + logf(l);
  }
}

template <int DP>
int launch(const Params& p, int bh, int is_f32, cudaStream_t stream) {
  if (is_f32) {
    const dim3 grid((p.T + kF32Rows - 1) / kF32Rows, bh);
    attn_fwd_f32<DP><<<grid, kF32Rows, 0, stream>>>(p);
  } else {
    constexpr int smem = Tiling<DP>::kSmemBytes;
    if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
      const cudaError_t err = cudaFuncSetAttribute(
          attn_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((p.T + Tiling<DP>::BQ - 1) / Tiling<DP>::BQ, bh);
    attn_fwd_bf16<DP><<<grid, kThreads, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Checks the shape, fills the rest of p and launches; -1 for a shape the
// kernel does not take.
int run(Params& p, int B, int T, int H, int D, float scale, int is_f32, int device,
        void* stream) {
  if (D < 8 || D > 128 || D % 8 != 0 || T < 1 || B < 1 || H < 1 || B * H > 65535)
    return -1;
  if (p.k.st != p.v.st) return -1;  // issue_kv addresses V rows from K rows
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  p.T = T;
  p.H = H;
  p.D = D;
  p.C = H * D;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch<16>(p, B * H, is_f32, st);
    case 32: return launch<32>(p, B * H, is_f32, st);
    case 48: return launch<48>(p, B * H, is_f32, st);
    case 64: return launch<64>(p, B * H, is_f32, st);
    case 80: return launch<80>(p, B * H, is_f32, st);
    case 96: return launch<96>(p, B * H, is_f32, st);
    case 112: return launch<112>(p, B * H, is_f32, st);
    case 128: return launch<128>(p, B * H, is_f32, st);
    default: return -1;
  }
}

}  // namespace

// Both entries return cudaGetLastError() after the launch (0 on success), or
// -1 for an argument the kernel does not take. Pointers are device pointers;
// out is [B, T, H, D] contiguous and lse, when not null, [B*H, T] f32. Every
// q/k/v row must start on 16 bytes: unit stride along D, strides multiples
// of 8 elements, 16-byte-aligned bases; k and v share their token stride
// (the wrappers check).

// q, k and v straight out of the fused projection qkv [B, T, 3C], strided
// along batch and token, channels (q|k|v)-major (new_order) or head-major
extern "C" int eo_qkv_attention_fwd_mma(const void* qkv, void* out, float* lse, int is_f32,
                                        int B, int T, int H, int D, long long stride_b,
                                        long long stride_t, int new_order, float scale,
                                        int device, void* stream) {
  const long long C = (long long)H * D;
  const size_t esize = is_f32 ? 4 : 2;
  Params p;
  Plane* planes[3] = {&p.q, &p.k, &p.v};
  for (int j = 0; j < 3; ++j) {
    planes[j]->ptr = static_cast<const char*>(qkv) + esize * (new_order ? j * C : j * D);
    planes[j]->sb = stride_b;
    planes[j]->st = stride_t;
    planes[j]->sh = new_order ? D : 3LL * D;
  }
  p.out = out;
  p.lse = lse;
  return run(p, B, T, H, D, scale, is_f32, device, stream);
}

// q, k and v as three [B, T, H, D] tensors or views; strides holds their
// (batch, token, head) strides in elements, q's three first
extern "C" int eo_attention_fwd_mma(const void* q, const void* k, const void* v,
                                    const long long* strides, void* out, float* lse,
                                    int is_f32, int B, int T, int H, int D, float scale,
                                    int device, void* stream) {
  Params p;
  const void* ptrs[3] = {q, k, v};
  Plane* planes[3] = {&p.q, &p.k, &p.v};
  for (int j = 0; j < 3; ++j) {
    planes[j]->ptr = ptrs[j];
    planes[j]->sb = strides[3 * j];
    planes[j]->st = strides[3 * j + 1];
    planes[j]->sh = strides[3 * j + 2];
  }
  p.out = out;
  p.lse = lse;
  return run(p, B, T, H, D, scale, is_f32, device, stream);
}
