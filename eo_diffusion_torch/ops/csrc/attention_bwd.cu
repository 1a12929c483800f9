// Self-attention backward for Hopper (sm_90a) on mma.sync, bound through
// ctypes: the port's first backward body, and its float32 kernel.
//
// Since the wgmma/TMA body (attention_bwd_sm90.cu) took every bf16 launch of
// the model paths, this file's entries carry the suffix _mma: through them
// bf16 runs the mma.sync body below, which no model path calls and which
// chip_smoke.py times beside the new body as its yardstick, and float32 runs
// the FMA kernel, which the wrappers still route every float32 backward to
// (ops/attention.py, bwd_route).
//
// Replaces the TPU kernels `_resident_bwd_kernel_tpv` / `_resident_bwd_kernel`
// (eo_diffusion_tpu/ops/attention.py:502 / :429, launched by `_flash_bwd_impl`
// at :569 and entered through `_qkv5_bwd` at :858 and `_flash_bwd` at :669),
// and for T > 4096 the XLA recompute that `_flash_bwd` falls back to. It
// computes the same
// function from the forward's saved row logsumexp, not the same block
// structure. Per batch and head, with s = D^-1/4:
//
//   qs = q*s, ks = k*s            (rounded to the input dtype, as the forward)
//   S  = qs ks^T                  (f32)
//   P  = exp(S - lse)             (f32; key columns past T give 0)
//   delta = rowsum(dO * O)        (f32)
//   dP = dO V^T                   (f32)
//   dS = P * (dP - delta)         (f32)
//   dV = P_b^T dO                 P_b  = P  rounded to the input dtype
//   dQ = (dS_b ks) * s            dS_b = dS rounded to the input dtype
//   dK = (dS_b^T qs) * s
//
// dQ, dK and dV accumulate in f32 and round once. q, k, v and the three
// gradients are strided planes, element (b, t, h, d) at ptr + b*sb + t*st +
// h*sh + d (as in attention_fwd.cu): entry `eo_qkv_attention_bwd_mma` reads q,
// k, v straight out of the projection qkv [B, T, 3C] and writes the
// gradients straight into dqkv [B, T, 3C] in the projection's head order;
// `eo_attention_bwd_mma` takes three [B, T, H, D] tensors or views each way.
// One kernel body serves both, so no slice, transpose or stack surrounds
// it. O and dO are [B, T, H, D] contiguous ([B, T, C] at channel h*D + d).
// lse is the forward's [B*H, T] f32 natural-log row statistic; the
// exponentials run in base 2 on lse * log2(e).
//
// What bounds it on the H100: five products of 2*T^2*D each, 10*B*H*T^2*D
// FLOPs. At the clouds UNet's ds-4 training shape (B 8, T 4096, 8 heads of
// D 48) that is 515 GFLOP against about 200 MB of q/k/v/o/do/dq/dk/dv
// traffic: compute-bound, with a lower bound of 515 GFLOP / 989 TFLOP/s =
// 0.52 ms. The T x T probabilities never reach device memory.
//
// Design. Thread blocks run in no order, so dK and dV cannot accumulate
// across a sequential q-tile axis as on the TPU. The work is split into two
// passes that share one kernel body (template flag KV), each with exclusive
// ownership of what it writes, so there are no atomics and the result is
// bit-reproducible from run to run:
//   * KV pass: a block of four warps owns 128 keys (32 per warp; 64 and 16
//     for D > 48). Its K*s and V rows live in registers as mma A fragments;
//     Q*s and dO tiles (plus their lse and delta entries) stream through a
//     two-stage cp.async ring. It forms S^T = ks qs^T and dP^T = V dO^T, then
//     dV += P_b^T dO and dK += dS_b^T qs with the transposed probabilities
//     re-packed in registers as A operands.
//   * Q pass: a block owns 128 query rows (64 for D > 64); K*s and V tiles
//     stream; it forms S and dP and accumulates dQ += dS_b ks.
// With 32 rows a warp every K/V/Q/dO fragment read from shared memory feeds
// two products, and a streamed tile is consumed 16 rows at a time so that
// the live piece of the T x T tiles stays small.
// S and P are computed twice (seven products instead of five); that buys
// the absence of an f32 dQ buffer, of atomics and of a conversion pass.
// delta is a small kernel of its own before the two passes. All products are
// mma.sync m16n8k16 bf16 with f32 accumulators; D = 48 is three k16 slices.
// For D > 64 the streamed tile shrinks from 64 to 32 rows to hold the
// accumulators in registers. attention_bwd_sm90.cu is its wgmma/TMA redesign.
//
// The float32 path (--no_bf16) is a plain FMA kernel of the same two passes:
// one thread per owned row, streamed tiles in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kF32Rows = 128;       // rows a block owns (f32 kernels), one per thread
constexpr int kF32BN = 16;          // streamed rows per tile (f32 kernels)
constexpr float kLog2e = 1.4426950408889634f;

// bf16 tiling for head dims padded to DP (a multiple of 16)
template <int DP>
struct Tiling {
  static constexpr int LD = DP + 8;              // +16 B per row: conflict-free fragment loads
  static constexpr int BN = DP <= 64 ? 64 : 32;  // streamed rows per tile
  static constexpr int kStage = 2 * BN * LD;     // two tiles per stage, elements
  static constexpr int kVecBytes = 2 * 2 * BN * 4;  // lse and delta per stage, f32
  static constexpr int kSmemBytes = kVecBytes + 2 * kStage * 2;
  static_assert(kSmemBytes <= 48 * 1024, "fits without the opt-in");
  static_assert(2 * BN <= kThreads, "one thread per streamed lse/delta entry");
};

// m16 tiles of owned rows a warp holds (bf16 kernels): two where the
// accumulators of the pass still fit in registers. The KV pass carries two
// output accumulators (dK and dV), the Q pass one (dQ).
template <int DP, bool KV>
constexpr int kMT = (KV ? DP <= 48 : DP <= 64) ? 2 : 1;

// element (b, t, h, d) of a [B, T, H, D] operand at ptr + b*sb + t*st + h*sh + d
struct Plane {
  void* ptr;
  long long sb, st, sh;
};

struct Params {
  Plane q, k, v;       // inputs
  Plane dq, dk, dv;    // outputs
  const void* out;     // [B, T, H, D] contiguous: the forward's output
  const void* dout;    // [B, T, H, D] contiguous: its gradient
  const float* lse;    // [B*H, T]
  float* delta;        // [B*H, T] scratch
  int B, T, H, D, C;
  float scale_in;      // D^-1/4 rounded to the input dtype: q*s and k*s
  float scale_out;     // D^-1/4 in f32: the chain rule's factor on dq and dk
};

// row t = 0 of head h of batch b (E const for an input)
template <typename E>
__device__ __forceinline__ E* plane_at(const Plane& pl, int b, int h) {
  return static_cast<E*>(pl.ptr) + (long long)b * pl.sb + (long long)h * pl.sh;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two packed bf16 values times s, each product rounded once to bf16
__device__ __forceinline__ uint32_t scale2(uint32_t x, __nv_bfloat162 s2) {
  __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&x), s2);
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

// B operand (k16 x n8) from rows [k][n] in shared memory
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

// 4-byte asynchronous copy to shared memory; zero-fills when !in
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// delta[b*H + h][t] = sum_d dO * O in f32, one thread per (b, t, h)
template <typename E>
__global__ void __launch_bounds__(256) attn_bwd_delta(Params p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.B * p.T * p.H) return;
  const int h = static_cast<int>(i % p.H);
  const long long bt = i / p.H;
  const int t = static_cast<int>(bt % p.T);
  const long long b = bt / p.T;
  const E* o = static_cast<const E*>(p.out) + bt * p.C + (long long)h * p.D;
  const E* g = static_cast<const E*>(p.dout) + bt * p.C + (long long)h * p.D;
  float acc = 0.f;
  for (int d = 0; d < p.D; d += 8) {
    if constexpr (sizeof(E) == 2) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + d);
      const uint4 gv = *reinterpret_cast<const uint4*>(g + d);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 of = __bfloat1622float2(o2[k]);
        const float2 gf = __bfloat1622float2(g2[k]);
        acc = fmaf(gf.x, of.x, acc);
        acc = fmaf(gf.y, of.y, acc);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; k += 4) {
        const float4 of = *reinterpret_cast<const float4*>(o + d + k);
        const float4 gf = *reinterpret_cast<const float4*>(g + d + k);
        acc = fmaf(gf.x, of.x, acc);
        acc = fmaf(gf.y, of.y, acc);
        acc = fmaf(gf.z, of.z, acc);
        acc = fmaf(gf.w, of.w, acc);
      }
    }
  }
  p.delta[(b * p.H + h) * p.T + t] = acc;
}

// Issue the copies of rows [n0, n0 + BN) of two [*, D] matrices into one
// stage (rows >= T and columns >= D zero-filled). D % 8 == 0, so a 16-byte
// chunk is all in or all out.
template <int DP>
__device__ __forceinline__ void issue_tiles(__nv_bfloat16* s1, __nv_bfloat16* s2,
                                            const __nv_bfloat16* src1, long long ld1,
                                            const __nv_bfloat16* src2, long long ld2,
                                            int n0, int T, int D) {
  constexpr int LD = Tiling<DP>::LD;
  constexpr int BN = Tiling<DP>::BN;
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < BN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int d = (i % kChunks) * 8;
    const bool in = n0 + r < T && d < D;
    cp_async16(s1 + r * LD + d, in ? src1 + (long long)(n0 + r) * ld1 + d : src1, in);
    cp_async16(s2 + r * LD + d, in ? src2 + (long long)(n0 + r) * ld2 + d : src2, in);
  }
}

// x * s in place for the chunks of the first tile this thread copied (same
// indexing as issue_tiles); its copies are visible to it after the wait
template <int DP>
__device__ __forceinline__ void scale_tile(__nv_bfloat16* s1, __nv_bfloat162 s2v) {
  constexpr int LD = Tiling<DP>::LD;
  constexpr int BN = Tiling<DP>::BN;
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < BN * kChunks; i += kThreads) {
    uint4* ptr = reinterpret_cast<uint4*>(s1 + (i / kChunks) * LD + (i % kChunks) * 8);
    uint4 v = *ptr;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = __hmul2(e[k], s2v);
    *ptr = v;
  }
}

// One body for both passes. A warp owns MT m16 tiles of the "A side" (a block
// 16 * MT * kWarps rows) and the block streams the "B side":
//   KV pass: A1 = k*s, A2 = v  (rows = keys);    B1 = q*s, B2 = dO (rows = queries)
//   Q pass:  A1 = q*s, A2 = dO (rows = queries); B1 = k*s, B2 = v  (rows = keys)
// X = A1 B1^T is S (Q pass) or S^T (KV pass); Y = A2 B2^T is dP or dP^T.
// lse and delta belong to the query: the owned row in the Q pass, the
// streamed column in the KV pass. Then out1 += dS_b B1 (dQ or dK) and, in
// the KV pass, out2 += P_b B2 (dV). A streamed tile is consumed in chunks of
// 16 rows: X and Y of a chunk, its P and dS, then its share of the outputs,
// so only a [16 * MT, 16] piece of the two T x T tiles is live at a time and
// every B fragment read from shared memory feeds MT products.
template <int DP, bool KV>
__global__ void __launch_bounds__(kThreads) attn_bwd_bf16(Params p) {
  using Tl = Tiling<DP>;
  constexpr int LD = Tl::LD;
  constexpr int BN = Tl::BN;
  constexpr int KS = DP / 16;  // k16 slices of the head dim
  constexpr int NT = DP / 8;   // n8 tiles of the head dim
  constexpr int MT = kMT<DP, KV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* svec = reinterpret_cast<float*>(smem_raw);  // [stage][lse | delta][BN]
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw + Tl::kVecBytes);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread within the group
  const __nv_bfloat16* gbase = static_cast<const __nv_bfloat16*>(p.dout) +
                               (long long)b * p.T * p.C + (long long)h * p.D;
  const float* lse = p.lse + (long long)bh * p.T;
  const float* delta = p.delta + (long long)bh * p.T;
  const __nv_bfloat162 s2v = __float2bfloat162_rn(p.scale_in);
  const __nv_bfloat16* q_plane = plane_at<const __nv_bfloat16>(p.q, b, h);
  const __nv_bfloat16* k_plane = plane_at<const __nv_bfloat16>(p.k, b, h);
  const __nv_bfloat16* v_plane = plane_at<const __nv_bfloat16>(p.v, b, h);

  // A fragments of the owned rows, straight from device memory (read once)
  const __nv_bfloat16* a1_src = KV ? k_plane : q_plane;
  const long long a1_ld = KV ? p.k.st : p.q.st;
  const __nv_bfloat16* a2_src = KV ? v_plane : gbase;
  const long long a2_ld = KV ? p.v.st : (long long)p.C;
  const __nv_bfloat16* b1_src = KV ? q_plane : k_plane;
  const long long b1_ld = KV ? p.q.st : p.k.st;
  const __nv_bfloat16* b2_src = KV ? gbase : v_plane;
  const long long b2_ld = KV ? (long long)p.C : p.v.st;

  const int row_lo = (blockIdx.x * kWarps + warp) * 16 * MT + g;
  uint32_t a1[MT][KS][4], a2[MT][KS][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + 16 * m + 8 * (e & 1);
        const int col = kk * 16 + tq * 2 + 8 * (e >> 1);
        const bool in = row < p.T && col < p.D;
        a1[m][kk][e] =
            in ? scale2(ld_u32(a1_src + (long long)row * a1_ld + col), s2v) : 0u;
        a2[m][kk][e] = in ? ld_u32(a2_src + (long long)row * a2_ld + col) : 0u;
      }
    }
  }
  // Q pass: the owned rows' lse (in base 2) and delta
  float row_l2[MT][2], row_dl[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 16 * m + 8 * r;
      const bool in = !KV && row < p.T;
      row_l2[m][r] = in ? lse[row] * kLog2e : 0.f;
      row_dl[m][r] = in ? delta[row] : 0.f;
    }
  }

  float o1[MT][NT][4], o2[MT][KV ? NT : 1][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) o1[m][n][0] = o1[m][n][1] = o1[m][n][2] = o1[m][n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < (KV ? NT : 1); ++n)
      o2[m][n][0] = o2[m][n][1] = o2[m][n][2] = o2[m][n][3] = 0.f;
  }

  const int n_tiles = (p.T + BN - 1) / BN;
  auto issue = [&](int tile) {
    __nv_bfloat16* st = smem + (tile & 1) * Tl::kStage;
    issue_tiles<DP>(st, st + BN * LD, b1_src, b1_ld, b2_src, b2_ld, tile * BN, p.T, p.D);
    if (KV && threadIdx.x < 2 * BN) {
      const int which = threadIdx.x / BN;  // 0 lse, 1 delta
      const int c = threadIdx.x % BN;
      const int col = tile * BN + c;
      const bool in = col < p.T;
      const float* src = which ? delta : lse;
      cp_async4(svec + ((tile & 1) * 2 + which) * BN + c, in ? src + col : src, in);
    }
  };

  issue(0);
  cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    __nv_bfloat16* sB1 = smem + (kt & 1) * Tl::kStage;
    __nv_bfloat16* sB2 = sB1 + BN * LD;
    const float* s_lse = svec + (kt & 1) * 2 * BN;
    const float* s_dl = s_lse + BN;
    if (kt + 1 < n_tiles) issue(kt + 1);
    cp_async_commit();  // possibly empty: keeps one group per tile
    cp_async_wait_1();  // tile kt has landed
    scale_tile<DP>(sB1, s2v);
    __syncthreads();

    const int n0 = kt * BN;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      // X = A1 B1^T and Y = A2 B2^T: 16 * MT owned rows x 16 streamed rows
      float x[MT][2][4], y[MT][2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          x[m][nn][0] = x[m][nn][1] = x[m][nn][2] = x[m][nn][3] = 0.f;
          y[m][nn][0] = y[m][nn][1] = y[m][nn][2] = y[m][nn][3] = 0.f;
        }
        const __nv_bfloat16* r1 = sB1 + (j * 16 + nn * 8 + g) * LD + tq * 2;
        const __nv_bfloat16* r2 = sB2 + (j * 16 + nn * 8 + g) * LD + tq * 2;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint32_t b10 = ld_u32(r1 + kk * 16), b11 = ld_u32(r1 + kk * 16 + 8);
          const uint32_t b20 = ld_u32(r2 + kk * 16), b21 = ld_u32(r2 + kk * 16 + 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(x[m][nn], a1[m][kk], b10, b11);
            mma_bf16(y[m][nn], a2[m][kk], b20, b21);
          }
        }
      }

      // P = exp2(X log2e - lse log2e), dS = P (Y - delta); streamed rows past
      // T give P = 0 (padded keys in the Q pass, padded queries in the KV
      // pass). Two n8 tiles make one k16 A fragment of the output products
      uint32_t dsa[MT][4], pa[KV ? MT : 1][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // the fragment's two rows: g and g + 8
          float l2c[2], dlc[2];
          bool in[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = j * 16 + nn * 8 + tq * 2 + e;
            in[e] = n0 + c < p.T;
            l2c[e] = KV ? s_lse[c] * kLog2e : 0.f;
            dlc[e] = KV ? s_dl[c] : 0.f;
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float pv[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float l2 = KV ? l2c[e] : row_l2[m][h2];
              const float dl = KV ? dlc[e] : row_dl[m][h2];
              pv[e] = in[e] ? ex2(fmaf(x[m][nn][2 * h2 + e], kLog2e, -l2)) : 0.f;
              ds[e] = pv[e] * (y[m][nn][2 * h2 + e] - dl);
            }
            dsa[m][2 * nn + h2] = pack_bf16(ds[0], ds[1]);
            if constexpr (KV) pa[m][2 * nn + h2] = pack_bf16(pv[0], pv[1]);
          }
        }
      }

      // out1 += dS_b B1, out2 += P_b B2
      const __nv_bfloat16* br1 = sB1 + (j * 16 + (lane & 15)) * LD;
      const __nv_bfloat16* br2 = sB2 + (j * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, br1 + n * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(o1[m][n], dsa[m], b0, b1);
        if constexpr (KV) {
          ldsm_x2_trans(b0, b1, br2 + n * 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16(o2[m][n], pa[m], b0, b1);
        }
      }
    }
    __syncthreads();  // stage kt & 1 is refilled with tile kt + 2 next
  }

  // epilogue: round once, write dk and dv (KV pass) or dq (Q pass)
  const Plane& p1 = KV ? p.dk : p.dq;
  __nv_bfloat16* d1 = plane_at<__nv_bfloat16>(p1, b, h);
  __nv_bfloat16* d2 = plane_at<__nv_bfloat16>(p.dv, b, h);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 16 * m + 8 * r;
      if (row >= p.T) continue;
      __nv_bfloat16* drow1 = d1 + (long long)row * p1.st;
      __nv_bfloat16* drow2 = d2 + (long long)row * p.dv.st;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = n * 8 + tq * 2;
        if (d >= p.D) continue;
        *reinterpret_cast<__nv_bfloat162*>(drow1 + d) = __floats2bfloat162_rn(
            o1[m][n][2 * r] * p.scale_out, o1[m][n][2 * r + 1] * p.scale_out);
        if constexpr (KV)
          *reinterpret_cast<__nv_bfloat162*>(drow2 + d) =
              __floats2bfloat162_rn(o2[m][n][2 * r], o2[m][n][2 * r + 1]);
      }
    }
  }
}

// float32: one thread per owned row, the same two passes with FMAs
template <int DP, bool KV>
__global__ void __launch_bounds__(kF32Rows) attn_bwd_f32(Params p) {
  __shared__ __align__(16) float sB1[kF32BN][DP];
  __shared__ __align__(16) float sB2[kF32BN][DP];
  __shared__ float s_lse[kF32BN];
  __shared__ float s_dl[kF32BN];

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int row = blockIdx.x * kF32Rows + threadIdx.x;
  const bool own = row < p.T;
  const float* gbase =
      static_cast<const float*>(p.dout) + (long long)b * p.T * p.C + (long long)h * p.D;
  const float* lse = p.lse + (long long)bh * p.T;
  const float* delta = p.delta + (long long)bh * p.T;
  const float* q_plane = plane_at<const float>(p.q, b, h);
  const float* k_plane = plane_at<const float>(p.k, b, h);
  const float* v_plane = plane_at<const float>(p.v, b, h);
  const float* a1_src = KV ? k_plane : q_plane;
  const long long a1_ld = KV ? p.k.st : p.q.st;
  const float* a2_src = KV ? v_plane : gbase;
  const long long a2_ld = KV ? p.v.st : (long long)p.C;
  const float* b1_src = KV ? q_plane : k_plane;
  const long long b1_ld = KV ? p.q.st : p.k.st;
  const float* b2_src = KV ? gbase : v_plane;
  const long long b2_ld = KV ? (long long)p.C : p.v.st;

  float a1[DP], a2[DP], o1[DP], o2[KV ? DP : 1];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    const bool in = own && d < p.D;
    a1[d] = in ? a1_src[(long long)row * a1_ld + d] * p.scale_in : 0.f;
    a2[d] = in ? a2_src[(long long)row * a2_ld + d] : 0.f;
    o1[d] = 0.f;
    if constexpr (KV) o2[d] = 0.f;
  }
  if constexpr (!KV) o2[0] = 0.f;
  const float row_lse = (!KV && own) ? lse[row] : 0.f;
  const float row_dl = (!KV && own) ? delta[row] : 0.f;

  const int n_tiles = (p.T + kF32BN - 1) / kF32BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * kF32BN;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BN * (DP / 4); i += kF32Rows) {
      const int r = i / (DP / 4);
      const int d = (i % (DP / 4)) * 4;
      float4 v1 = make_float4(0.f, 0.f, 0.f, 0.f), v2 = v1;
      if (n0 + r < p.T && d < p.D) {
        v1 = *reinterpret_cast<const float4*>(b1_src + (long long)(n0 + r) * b1_ld + d);
        v2 = *reinterpret_cast<const float4*>(b2_src + (long long)(n0 + r) * b2_ld + d);
        v1.x *= p.scale_in; v1.y *= p.scale_in; v1.z *= p.scale_in; v1.w *= p.scale_in;
      }
      *reinterpret_cast<float4*>(&sB1[r][d]) = v1;
      *reinterpret_cast<float4*>(&sB2[r][d]) = v2;
    }
    if (KV && threadIdx.x < kF32BN) {
      const int col = n0 + threadIdx.x;
      s_lse[threadIdx.x] = col < p.T ? lse[col] : 0.f;
      s_dl[threadIdx.x] = col < p.T ? delta[col] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int j = 0; j < kF32BN && n0 + j < p.T; ++j) {
      float xj = 0.f, yj = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        xj = fmaf(a1[d], sB1[j][d], xj);
        yj = fmaf(a2[d], sB2[j][d], yj);
      }
      const float pj = expf(xj - (KV ? s_lse[j] : row_lse));
      const float dsj = pj * (yj - (KV ? s_dl[j] : row_dl));
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        o1[d] = fmaf(dsj, sB1[j][d], o1[d]);
        if constexpr (KV) o2[d] = fmaf(pj, sB2[j][d], o2[d]);
      }
    }
  }

  if (own) {
    const Plane& p1 = KV ? p.dk : p.dq;
    float* d1 = plane_at<float>(p1, b, h) + (long long)row * p1.st;
    float* d2 = plane_at<float>(p.dv, b, h) + (long long)row * p.dv.st;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      if (d < p.D) {
        d1[d] = o1[d] * p.scale_out;
        if constexpr (KV) d2[d] = o2[d];
      }
    }
  }
}

template <int DP>
int launch(const Params& p, int is_f32, cudaStream_t stream) {
  const int bh = p.B * p.H;
  const long long n_rows = (long long)bh * p.T;
  const unsigned delta_blocks = static_cast<unsigned>((n_rows + 255) / 256);
  if (is_f32) {
    attn_bwd_delta<float><<<delta_blocks, 256, 0, stream>>>(p);
    const dim3 grid((p.T + kF32Rows - 1) / kF32Rows, bh);
    attn_bwd_f32<DP, true><<<grid, kF32Rows, 0, stream>>>(p);
    attn_bwd_f32<DP, false><<<grid, kF32Rows, 0, stream>>>(p);
  } else {
    attn_bwd_delta<__nv_bfloat16><<<delta_blocks, 256, 0, stream>>>(p);
    constexpr int smem = Tiling<DP>::kSmemBytes;
    constexpr int kv_rows = 16 * kMT<DP, true> * kWarps;
    constexpr int q_rows = 16 * kMT<DP, false> * kWarps;
    attn_bwd_bf16<DP, true>
        <<<dim3((p.T + kv_rows - 1) / kv_rows, bh), kThreads, smem, stream>>>(p);
    attn_bwd_bf16<DP, false>
        <<<dim3((p.T + q_rows - 1) / q_rows, bh), kThreads, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Checks the shape, fills the rest of p and launches; -1 for a shape the
// kernel does not take.
int run(Params& p, int B, int T, int H, int D, float scale_in, float scale_out, int is_f32,
        int device, void* stream) {
  if (D < 8 || D > 128 || D % 8 != 0 || T < 1 || B < 1 || H < 1 || B * H > 65535)
    return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  p.B = B;
  p.T = T;
  p.H = H;
  p.D = D;
  p.C = H * D;
  p.scale_in = scale_in;
  p.scale_out = scale_out;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch<16>(p, is_f32, st);
    case 32: return launch<32>(p, is_f32, st);
    case 48: return launch<48>(p, is_f32, st);
    case 64: return launch<64>(p, is_f32, st);
    case 80: return launch<80>(p, is_f32, st);
    case 96: return launch<96>(p, is_f32, st);
    case 112: return launch<112>(p, is_f32, st);
    case 128: return launch<128>(p, is_f32, st);
    default: return -1;
  }
}

}  // namespace

// Both entries return cudaGetLastError() after the launches (0 on success),
// or -1 for an argument the kernel does not take. Pointers are device
// pointers. Every q/k/v/dq/dk/dv row must start on 16 bytes: unit stride
// along D, strides multiples of 8 elements, 16-byte-aligned bases; out and
// dout are [B, T, H, D] contiguous with 16-byte-aligned bases; lse and delta
// are [B*H, T] f32 (the wrappers check and allocate).

// q, k, v read from the fused projection qkv [B, T, 3C] (strided along batch
// and token, either head order); dq, dk, dv written into dqkv [B, T, 3C],
// contiguous, in the same head order
extern "C" int eo_qkv_attention_bwd_mma(const void* qkv, const void* out, const void* dout,
                                    const float* lse, float* delta, void* dqkv, int is_f32,
                                    int B, int T, int H, int D, long long stride_b,
                                    long long stride_t, int new_order, float scale_in,
                                    float scale_out, int device, void* stream) {
  const long long C = (long long)H * D;
  const size_t esize = is_f32 ? 4 : 2;
  Params p;
  Plane* in[3] = {&p.q, &p.k, &p.v};
  Plane* grad[3] = {&p.dq, &p.dk, &p.dv};
  for (int j = 0; j < 3; ++j) {
    const size_t off = esize * (new_order ? j * C : j * D);
    const long long sh = new_order ? D : 3LL * D;
    *in[j] = {const_cast<char*>(static_cast<const char*>(qkv)) + off, stride_b, stride_t, sh};
    *grad[j] = {static_cast<char*>(dqkv) + off, (long long)T * 3 * C, 3 * C, sh};
  }
  p.out = out;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  return run(p, B, T, H, D, scale_in, scale_out, is_f32, device, stream);
}

// q, k, v and dq, dk, dv as six [B, T, H, D] tensors or views; strides holds
// their (batch, token, head) strides in elements in that order, 18 values
extern "C" int eo_attention_bwd_mma(const void* q, const void* k, const void* v, void* dq,
                                void* dk, void* dv, const long long* strides, const void* out,
                                const void* dout, const float* lse, float* delta, int is_f32,
                                int B, int T, int H, int D, float scale_in, float scale_out,
                                int device, void* stream) {
  Params p;
  void* ptrs[6] = {const_cast<void*>(q), const_cast<void*>(k), const_cast<void*>(v),
                   dq, dk, dv};
  Plane* planes[6] = {&p.q, &p.k, &p.v, &p.dq, &p.dk, &p.dv};
  for (int j = 0; j < 6; ++j)
    *planes[j] = {ptrs[j], strides[3 * j], strides[3 * j + 1], strides[3 * j + 2]};
  p.out = out;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  return run(p, B, T, H, D, scale_in, scale_out, is_f32, device, stream);
}
