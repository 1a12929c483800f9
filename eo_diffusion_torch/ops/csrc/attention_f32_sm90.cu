// Self-attention in float32 for Hopper (sm_90a) on the tensor cores, bound
// through ctypes: the float32 forward (both entries) and the float32
// backward (both entries), every product a three-term TF32 split.
//
// Replaces, in float32 (`--no_bf16`, the EncoderUNet classifier), the TPU
// kernels that attention_fwd_sm90.cu and attention_bwd_sm90.cu replace in
// bf16:
//   * K1, `_qkv_layout_kernel_tpv` / `_qkv_layout_kernel`
//     (eo_diffusion_tpu/ops/attention.py:738 / :697, launched by
//     `_qkv5_fwd_impl` at :797): q, k, v read from the fused projection;
//   * K2 / K3, `_resident_kernel` (:271) and `_flash_kernel` (:227), the
//     branches of `_flash_fwd_impl` (:333), here the separate-tensor entry;
//   * K4, `_resident_bwd_kernel_tpv` / `_resident_bwd_kernel` (:502 / :429,
//     launched by `_flash_bwd_impl` at :569), both entries.
// It computes what attention_fwd.cu's and attention_bwd.cu's FMA kernels
// compute (those stay as the yardstick), with the JAX package's numerical
// contract: q and k each scaled by s = D^-1/4 (f32), o = softmax(qs ks^T) v
// with f32 row statistics m, l, the lse = m + log(l) as [B*H, T] f32, a
// row with no key gives 0 and lse = +0.7*FLT_MAX; the backward recomputes
// p = exp(S - lse) and takes dS = p * (dP - delta), delta = rowsum(dO * O),
// dV = p^T dO, dQ = (dS ks) s, dK = (dS^T qs) s.
//
// The three-term split. Each product runs on the tensor cores in TF32 with
// f32 accumulation: x = hi + lo with hi = tf32(x) (cvt.rna.tf32.f32) and lo
// = x - hi, exact in f32 (the tensor core reads lo's leading 10 mantissa
// bits), and a*b = a_hi*b_hi + a_hi*b_lo + a_lo*b_hi (small terms first).
// The dropped a_lo*b_lo and lo's own truncation are about 2^-21 of |ab|:
// float32-level error, where one TF32 product keeps about 2^-11. Every
// operand is split: q, k, v, dO, p and dS. The template flag TERMS = 1
// keeps only a_hi*b_hi (plain TF32); nothing but the accuracy check
// (eo_attention_*_tf32x1, chip_smoke.py and the card tests) launches it, to
// show that the check can tell the two apart.
//
// What bounds it on the H100: the products. Dense TF32 runs at 495 TFLOP/s,
// so f32-accurate products at a third of it, about 165 TFLOP/s; the FMA
// units give 67. At the clouds UNet's `--no_bf16` ds-4 shape (B8 T4096 H8
// D48) a forward is 4*B*H*T^2*D = 206 GFLOP, at least 1.25 ms, against
// about 100 MB of q/k/v/o traffic: compute-bound.
//
// Instruction: mma.sync.m16n8k8 tf32, not wgmma. wgmma takes tf32 only with
// both operands K-major in shared memory, so PV needs V transposed on the
// way in and every split operand stored twice (hi and lo) in shared memory:
// twice the tile bytes per stage and a transpose per tile. With mma.sync the
// split is made in registers as a fragment is loaded, and the score
// accumulator feeds the next product directly: its columns (keys) 2t, 2t+1
// of a lane are not the A fragment's columns t, t+4, but a sum over keys
// does not care about their order, so the kernel names column t key 2t and
// column t+4 key 2t+1 and loads the V (dO, K, Q) rows in that order: no
// shuffle. A later redesign on wgmma would win the 2x issue rate of a
// warpgroup product; this one keeps f32 accuracy first.
//
// Design:
//   * a CTA of four warps owns 64 rows (16 a warp: one m16 tile), so B8 H4
//     T256 launches 128 CTAs and B8 T4096 H8 4096; its rows are staged once
//     in shared memory and each A fragment is loaded and split once per
//     16 head dims and used for every n tile of a streamed tile;
//   * the streamed tiles (K and V in the forward and the Q job; Q, dO and
//     their lse and delta in the key jobs) run through a two-stage cp.async
//     ring: tile k+1 loads while tile k is multiplied;
//   * bank conflicts: a streamed tile is read two ways, by rows (B of a score
//     product, 16 bytes a lane) and by columns (B of a value product, 4
//     bytes a lane from rows 2t, 2t+1). With rows LS = DP + 8 floats apart
//     and the n index g of a score tile naming row rho(g) = (0, 6, 1, 7, 2,
//     4, 3, 5)[g] of its 8, both reads hit 32 distinct banks. Owned rows
//     are LO floats apart, LO = 16 mod 32;
//   * the softmax runs in base 2 (ex2 on s*log2(e) - m*log2(e)), the row
//     statistics stay in registers, each lane's l a partial sum until the
//     end; streamed rows past T are zero-filled and masked to p = 0 (their
//     scores to -inf), so they add nothing;
//   * the backward: a delta kernel, then one grid whose blockIdx.z picks the
//     job: the KV job (a CTA owns 64 keys and writes their dK and dV) and
//     the Q job (64 queries, dQ); above D 64 the KV job is two, dV and dK
//     apart. Each CTA owns what it writes: no atomics, no [T, T] buffer, the
//     same bits on every run. A key job's f32 accumulators (dK and dV, or
//     one of them, 16 rows x DP; S^T and dP^T, 16 x BN, BN 32, 16 above D
//     96) stay in registers (ptxas's spill counts are in the build log;
//     chip_smoke.py prints them and holds D 64-128 to none).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using eo_tile::cp_async16;
using eo_tile::cp_async_commit;
using eo_tile::cp_async_wait;
using eo_tile::ex2;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a CTA owns
constexpr float kFullyMaskedLse = 0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;

// element (b, t, h, d) of a [B, T, H, D] operand at ptr + b*sb + t*st + h*sh + d
struct Plane {
  void* ptr;
  long long sb, st, sh;
};

struct Params {
  Plane q, k, v;     // inputs
  Plane dq, dk, dv;  // the backward's outputs
  void* out;         // [B, T, H, D] contiguous: the forward's output
  const void* dout;  // [B, T, H, D] contiguous: its gradient (backward)
  float* lse;        // [B*H, T]: written by the forward when not null, read by the backward
  float* delta;      // [B*H, T] scratch of the backward
  int B, T, H, D, C;
  float scale_in;   // D^-1/4: q*s and k*s
  float scale_out;  // D^-1/4: the chain rule's factor on dq and dk
};

// Tiling at head dims padded to DP (a multiple of 16)
template <int DP, bool BWD>
struct Tile {
  // streamed rows a tile: the backward's accumulators fit 255 registers
  static constexpr int BN = BWD ? (DP > 96 ? 16 : 32) : (DP > 64 ? 32 : 64);
  static constexpr int LS = DP + 8;                                 // streamed row stride
  static constexpr int LO = DP % 32 == 16 ? DP : DP + 16;           // owned row stride
  static constexpr int NT = BN / 8;                                 // n tiles of a score tile
  static constexpr int OWN = BWD ? 2 : 1;                           // owned operands
  static constexpr int kStage = 2 * BN * LS + (BWD ? 2 * BN : 0);   // floats a ring stage
  static constexpr int kSmemBytes = 4 * (OWN * kRows * LO + 2 * kStage);
  static_assert(LS % 16 == 8 && LO % 32 == 16, "bank-conflict-free strides");
  static_assert(kSmemBytes <= 227 * 1024, "one CTA fits an SM");
};

template <typename E>
__device__ __forceinline__ E* plane_at(const Plane& pl, int b, int h) {
  return static_cast<E*>(pl.ptr) + (long long)b * pl.sb + (long long)h * pl.sh;
}

// the row of its 8 that the n index i of a score tile names (see the header)
__device__ __forceinline__ int rho(int i) { return (i & 1) ? 4 + ((i >> 1) ^ 2) : i >> 1; }

// x = hi + lo: hi = tf32(x) rounded to nearest, lo = x - hi (exact in f32)
template <int TERMS>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  if (TERMS == 3) lo = __float_as_uint(x - __uint_as_float(hi));
}

// c[4] += a (16 x 8 tf32, row) * b (8 x 8 tf32, col), f32 accumulators.
// a: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b:
// b0 (k t, n g), b1 (k t + 4, n g); c: c0, c1 (row g, cols 2t, 2t + 1), c2,
// c3 (row g + 8) (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a*b in TERMS TF32 products: lo*hi and hi*lo first, then hi*hi
template <int TERMS>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  if (TERMS == 3) {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

// A score tile: acc[j] += (x * xs) (y * ys)^T over DP, x the warp's 16 owned
// rows (ldx apart), y a streamed tile (ldy apart); acc[j] covers y rows
// 8j + rho(2t), 8j + rho(2t + 1) (c0/c2 and c1/c3). A k pair of 16 head dims
// gives lane t the dims 4t..4t+3: k step 0 takes 4t (column t) and 4t + 1
// (column t + 4), k step 1 takes 4t + 2 and 4t + 3, so both operands load 16
// bytes a lane.
template <int DP, int NT, int TERMS>
__device__ __forceinline__ void score_tile(float (&acc)[NT][4], const float* x, int ldx,
                                           float xs, const float* y, int ldy, float ys, int g,
                                           int t) {
  const float* yrow = y + rho(g) * ldy + 4 * t;
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
    const float4 x0 = *reinterpret_cast<const float4*>(x + g * ldx + 16 * c + 4 * t);
    const float4 x1 = *reinterpret_cast<const float4*>(x + (g + 8) * ldx + 16 * c + 4 * t);
    uint32_t ah[2][4], al[2][4];
    split<TERMS>(x0.x * xs, ah[0][0], al[0][0]);
    split<TERMS>(x1.x * xs, ah[0][1], al[0][1]);
    split<TERMS>(x0.y * xs, ah[0][2], al[0][2]);
    split<TERMS>(x1.y * xs, ah[0][3], al[0][3]);
    split<TERMS>(x0.z * xs, ah[1][0], al[1][0]);
    split<TERMS>(x1.z * xs, ah[1][1], al[1][1]);
    split<TERMS>(x0.w * xs, ah[1][2], al[1][2]);
    split<TERMS>(x1.w * xs, ah[1][3], al[1][3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 yv = *reinterpret_cast<const float4*>(yrow + 8 * j * ldy + 16 * c);
      uint32_t bh[4], bl[4];
      split<TERMS>(yv.x * ys, bh[0], bl[0]);
      split<TERMS>(yv.y * ys, bh[1], bl[1]);
      split<TERMS>(yv.z * ys, bh[2], bl[2]);
      split<TERMS>(yv.w * ys, bh[3], bl[3]);
      mma3<TERMS>(acc[j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
      mma3<TERMS>(acc[j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// A value tile: o[n] (rows g, g + 8; head dims 8n + 2t, 8n + 2t + 1) += p z,
// p a score tile in score_tile's layout (its columns the streamed rows
// 8j + rho(.)), z that streamed tile times zs (rows ldz apart). Column t of
// the A fragment is p's column 2t (row rho(2t) of z), column t + 4 its column
// 2t + 1 (row rho(2t + 1)).
//
// The tensor core adds into its f32 accumulator without rounding to nearest
// (the low bits go), so a sum carried through thousands of mma.sync steps
// drifts by about a step's ulp each time: over T 4096 keys the output of a
// single running accumulator read 2.9e-5 of relative L2 off plain (H100
// 80GB HBM3, 700 W). Each tile's sum is therefore formed apart, hi*hi and the two
// small terms in accumulators of their own (a chain of NT steps), and added
// to o with one rounded FADD a tile.
template <int DP, int NT, int TERMS>
__device__ __forceinline__ void value_tile(float (&o)[DP / 8][4], const float (&p)[NT][4],
                                           const float* z, int ldz, float zs, int g, int t) {
  const float* z0 = z + t * ldz + g;             // row rho(2t) = t
  const float* z1 = z + (4 + (t ^ 2)) * ldz + g;  // row rho(2t + 1)
  uint32_t ah[NT][4], al[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split<TERMS>(p[j][0], ah[j][0], al[j][0]);
    split<TERMS>(p[j][2], ah[j][1], al[j][1]);
    split<TERMS>(p[j][1], ah[j][2], al[j][2]);
    split<TERMS>(p[j][3], ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split<TERMS>(z0[8 * j * ldz + 8 * n] * zs, bh0, bl0);
      split<TERMS>(z1[8 * j * ldz + 8 * n] * zs, bh1, bl1);
      if (TERMS == 3) {
        mma_tf32(small, al[j], bh0, bh1);
        mma_tf32(small, ah[j], bl0, bl1);
      }
      mma_tf32(big, ah[j], bh0, bh1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += big[e] + small[e];
  }
}

// rows [r0, r0 + n) of a plane (row r at src + r*ld) into dst, rows lds
// floats apart, DP floats each; zero where r >= T or d >= D
template <int DP>
__device__ __forceinline__ void stage_rows(float* dst, int lds, const float* src, long long ld,
                                           int r0, int n, int T, int D) {
  constexpr int kChunks = DP / 4;
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, d = (i % kChunks) * 4;
    const bool in = r0 + r < T && d < D;
    cp_async16(dst + r * lds + d, in ? src + (long long)(r0 + r) * ld + d : src, in);
  }
}

// n floats of a [B*H, T] row from index r0 into dst; zero past T
__device__ __forceinline__ void stage_stats(float* dst, const float* src, int r0, int n, int T) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool in = r0 + i < T;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :
                 : "r"(eo_tile::smem_addr(dst + i)), "l"(in ? src + r0 + i : src),
                   "r"(in ? 4 : 0)
                 : "memory");
  }
}

// two CTAs an SM: ptxas otherwise caps the forward's registers at 128 for
// an occupancy that its shared memory does not allow, and spills (the
// backward's own cap spills nothing from D 64 up and runs its T 4096 launch
// 3-4 % faster than at two CTAs; tools/profile_attn_f32.py, H100 80GB HBM3)
template <int DP, int TERMS>
__global__ void __launch_bounds__(kThreads, 2) attn_fwd_tf32(Params p) {
  using C = Tile<DP, false>;
  constexpr int NT = C::NT, BN = C::BN, LS = C::LS, LO = C::LO;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;               // [kRows][LO]
  float* ring = smem + kRows * LO;  // 2 stages of K [BN][LS], V [BN][LS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kRows;
  const float* qp = plane_at<const float>(p.q, b, h);
  const float* kp = plane_at<const float>(p.k, b, h);
  const float* vp = plane_at<const float>(p.v, b, h);

  stage_rows<DP>(sq, LO, qp, p.q.st, q0, kRows, p.T, p.D);
  auto issue = [&](int kt) {
    float* st = ring + (kt & 1) * C::kStage;
    stage_rows<DP>(st, LS, kp, p.k.st, kt * BN, BN, p.T, p.D);
    stage_rows<DP>(st + BN * LS, LS, vp, p.v.st, kt * BN, BN, p.T, p.D);
  };
  issue(0);
  cp_async_commit();

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float* xq = sq + warp * 16 * LO;

  const int n_tiles = (p.T + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      issue(kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = ring + (kt & 1) * C::kStage;
    const float* sv = sk + BN * LS;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    score_tile<DP, NT, TERMS>(s, xq, LO, p.scale_in, sk, LS, p.scale_in, g, t);

    const int k0 = kt * BN;
    if (k0 + BN > p.T) {  // the ragged tail: keys past T get no weight
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bool in0 = k0 + 8 * j + t < p.T, in1 = k0 + 8 * j + 4 + (t ^ 2) < p.T;
        if (!in0) s[j][0] = s[j][2] = -INFINITY;
        if (!in1) s[j][1] = s[j][3] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows g and g + 8
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mb = (mx == -INFINITY ? 0.f : mx) * kLog2e;  // no key yet: -inf - -inf
      const float alpha = ex2(m[r] * kLog2e - mb);              // 0 while m = -inf
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * r] = ex2(fmaf(s[j][2 * r], kLog2e, -mb));
        s[j][2 * r + 1] = ex2(fmaf(s[j][2 * r + 1], kLog2e, -mb));
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
    value_tile<DP, NT, TERMS>(o, s, sv, LS, 1.f, g, t);
    __syncthreads();  // the stage is refilled next
  }

  // epilogue: l summed over the row's four lanes, normalise once, o as
  // [B, T, C] at channel h*D + d
  float* out = static_cast<float*>(p.out) + (long long)b * p.T * p.C + (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.T) continue;
    const float inv = lr == 0.f ? 0.f : 1.f / lr;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < p.D)
        *reinterpret_cast<float2*>(out + (long long)row * p.C + d) =
            make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0)
      p.lse[(long long)bh * p.T + row] = lr == 0.f ? kFullyMaskedLse : m[r] + logf(lr);
  }
}

// delta[b*H + h][t] = sum_d dO * O in f32, one thread per (b, t, h)
__global__ void __launch_bounds__(256) attn_bwd_delta_f32(Params p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.B * p.T * p.H) return;
  const int h = static_cast<int>(i % p.H);
  const long long bt = i / p.H;
  const int t = static_cast<int>(bt % p.T);
  const long long b = bt / p.T;
  const float* o = static_cast<const float*>(p.out) + bt * p.C + (long long)h * p.D;
  const float* g = static_cast<const float*>(p.dout) + bt * p.C + (long long)h * p.D;
  float acc = 0.f;
  for (int d = 0; d < p.D; d += 4) {
    const float4 ov = *reinterpret_cast<const float4*>(o + d);
    const float4 gv = *reinterpret_cast<const float4*>(g + d);
    acc = fmaf(gv.x, ov.x, acc);
    acc = fmaf(gv.y, ov.y, acc);
    acc = fmaf(gv.z, ov.z, acc);
    acc = fmaf(gv.w, ov.w, acc);
  }
  p.delta[(b * p.H + h) * p.T + t] = acc;
}

// The backward's jobs: a CTA owns 64 rows and writes their gradients.
// kKV: 64 keys (K, V staged) streaming Q, dO and their lse and delta,
// writing dK and dV; above D 64 that is two jobs, kDV and kDK, so that one
// D-wide accumulator a lane stays in registers (kDV needs no dP^T). kQ: 64
// queries (Q, dO staged, their lse and delta in registers) streaming K and
// V, writing dQ.
enum Job { kKV, kDV, kDK, kQ };

template <int DP, int TERMS, int JOB>
__device__ __forceinline__ void bwd_pass(const Params& p, float* smem) {
  using C = Tile<DP, true>;
  constexpr int NT = C::NT, BN = C::BN, LS = C::LS, LO = C::LO;
  constexpr bool KV = JOB != kQ;                    // the rows owned are keys
  constexpr bool DV = JOB == kKV || JOB == kDV;     // writes dV
  constexpr bool DQK = JOB != kDV;                  // writes dK or dQ: needs dS
  float* own1 = smem;                  // [kRows][LO]: K (key jobs) or Q
  float* own2 = smem + kRows * LO;     // V or dO
  float* ring = smem + 2 * kRows * LO;  // 2 stages: Q|K [BN][LS], dO|V [BN][LS], lse, delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int r0 = blockIdx.x * kRows;
  const float* qp = plane_at<const float>(p.q, b, h);
  const float* kp = plane_at<const float>(p.k, b, h);
  const float* vp = plane_at<const float>(p.v, b, h);
  const float* gp = static_cast<const float*>(p.dout) + (long long)b * p.T * p.C +
                    (long long)h * p.D;
  const float* lse = p.lse + (long long)bh * p.T;
  const float* delta = p.delta + (long long)bh * p.T;
  const float* own1_src = KV ? kp : qp;
  const long long own1_ld = KV ? p.k.st : p.q.st;
  const float* own2_src = KV ? vp : gp;
  const long long own2_ld = KV ? p.v.st : (long long)p.C;
  const float* str1_src = KV ? qp : kp;
  const long long str1_ld = KV ? p.q.st : p.k.st;
  const float* str2_src = KV ? gp : vp;
  const long long str2_ld = KV ? (long long)p.C : p.v.st;

  stage_rows<DP>(own1, LO, own1_src, own1_ld, r0, kRows, p.T, p.D);
  if constexpr (DQK) stage_rows<DP>(own2, LO, own2_src, own2_ld, r0, kRows, p.T, p.D);
  auto issue = [&](int nt) {
    float* st = ring + (nt & 1) * C::kStage;
    stage_rows<DP>(st, LS, str1_src, str1_ld, nt * BN, BN, p.T, p.D);
    stage_rows<DP>(st + BN * LS, LS, str2_src, str2_ld, nt * BN, BN, p.T, p.D);
    if constexpr (KV) {
      stage_stats(st + 2 * BN * LS, lse, nt * BN, BN, p.T);
      stage_stats(st + 2 * BN * LS + BN, delta, nt * BN, BN, p.T);
    }
  };
  issue(0);
  cp_async_commit();

  float o1[DQK ? DP / 8 : 1][4], o2[DV ? DP / 8 : 1][4];  // dK or dQ; dV
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    if constexpr (DQK) o1[n][0] = o1[n][1] = o1[n][2] = o1[n][3] = 0.f;
    if constexpr (DV) o2[n][0] = o2[n][1] = o2[n][2] = o2[n][3] = 0.f;
  }
  // the Q job's own rows' statistics (rows past T read nothing and store nothing)
  float row_lse[2] = {0.f, 0.f}, row_dl[2] = {0.f, 0.f};
  if constexpr (!KV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + warp * 16 + g + 8 * r;
      if (row < p.T) {
        row_lse[r] = lse[row] * kLog2e;
        row_dl[r] = delta[row];
      }
    }
  }
  const float* x1 = own1 + warp * 16 * LO;
  const float* x2 = own2 + warp * 16 * LO;

  const int n_tiles = (p.T + BN - 1) / BN;
  for (int nt = 0; nt < n_tiles; ++nt) {
    if (nt + 1 < n_tiles) {
      issue(nt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* y1 = ring + (nt & 1) * C::kStage;  // Q (key jobs) or K
    const float* y2 = y1 + BN * LS;                 // dO or V
    const float* s_lse = y2 + BN * LS;
    const float* s_dl = s_lse + BN;

    // key jobs: S^T = ks qs^T, dP^T = v dO^T (rows: owned keys; columns: the
    // tile's queries). Q: S = qs ks^T, dP = dO v^T.
    float s[NT][4], dp[DQK ? NT : 1][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (DQK) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    score_tile<DP, NT, TERMS>(s, x1, LO, p.scale_in, y1, LS, p.scale_in, g, t);
    if constexpr (DQK) score_tile<DP, NT, TERMS>(dp, x2, LO, 1.f, y2, LS, 1.f, g, t);

    const int n0 = nt * BN;
    if (n0 + BN > p.T) {  // the ragged tail: streamed rows past T get p = 0
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n0 + 8 * j + t >= p.T) s[j][0] = s[j][2] = -INFINITY;
        if (n0 + 8 * j + 4 + (t ^ 2) >= p.T) s[j][1] = s[j][3] = -INFINITY;
      }
    }
    // p = exp(S - lse), dS = p * (dP - delta), in place of S and dP
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float l2, dl;
        if constexpr (KV) {  // the statistics of the column's query
          const int col = 8 * j + ((e & 1) ? 4 + (t ^ 2) : t);
          l2 = s_lse[col] * kLog2e;
          dl = s_dl[col];
        } else {  // those of the row's query
          l2 = row_lse[e >> 1];
          dl = row_dl[e >> 1];
        }
        const float pe = ex2(fmaf(s[j][e], kLog2e, -l2));
        s[j][e] = pe;
        if constexpr (DQK) dp[j][e] = pe * (dp[j][e] - dl);
      }
    }
    if constexpr (DV) value_tile<DP, NT, TERMS>(o2, s, y2, LS, 1.f, g, t);  // dV += p^T dO
    // dK += dS^T qs, or dQ += dS ks
    if constexpr (DQK) value_tile<DP, NT, TERMS>(o1, dp, y1, LS, p.scale_in, g, t);
    __syncthreads();  // the stage is refilled next
  }

  const Plane& p1 = KV ? p.dk : p.dq;
  float* d1 = plane_at<float>(p1, b, h);
  float* d2 = plane_at<float>(p.dv, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    if (row >= p.T) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d >= p.D) continue;
      if constexpr (DQK)
        *reinterpret_cast<float2*>(d1 + (long long)row * p1.st + d) =
            make_float2(o1[n][2 * r] * p.scale_out, o1[n][2 * r + 1] * p.scale_out);
      if constexpr (DV)
        *reinterpret_cast<float2*>(d2 + (long long)row * p.dv.st + d) =
            make_float2(o2[n][2 * r], o2[n][2 * r + 1]);
    }
  }
}

// the backward's jobs split dK from dV above D 64 (kSplitKV): blockIdx.z
// picks kKV, kQ up to D 64 and kDV, kDK, kQ above
template <int DP>
constexpr bool kSplitKV = DP > 64;

template <int DP, int TERMS>
__global__ void __launch_bounds__(kThreads) attn_bwd_tf32(Params p) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kSplitKV<DP>) {
    if (blockIdx.z == 0)
      bwd_pass<DP, TERMS, kDV>(p, smem);
    else if (blockIdx.z == 1)
      bwd_pass<DP, TERMS, kDK>(p, smem);
    else
      bwd_pass<DP, TERMS, kQ>(p, smem);
  } else {
    if (blockIdx.z == 0)
      bwd_pass<DP, TERMS, kKV>(p, smem);
    else
      bwd_pass<DP, TERMS, kQ>(p, smem);
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const Params& p) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int TERMS>
int launch_fwd(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.T + kRows - 1) / kRows, p.B * p.H);
  return launch(attn_fwd_tf32<DP, TERMS>, grid, Tile<DP, false>::kSmemBytes, stream, p);
}

template <int DP, int TERMS>
int launch_bwd(const Params& p, cudaStream_t stream) {
  const long long n_rows = (long long)p.B * p.H * p.T;
  attn_bwd_delta_f32<<<static_cast<unsigned>((n_rows + 255) / 256), 256, 0, stream>>>(p);
  const dim3 grid((p.T + kRows - 1) / kRows, p.B * p.H, kSplitKV<DP> ? 3 : 2);
  return launch(attn_bwd_tf32<DP, TERMS>, grid, Tile<DP, true>::kSmemBytes, stream, p);
}

// Checks the shape, fills the rest of p and launches the forward or the
// backward; -1 for what the kernel does not take (float32 only, TERMS 1 at
// D 48 and 64 only)
template <bool BWD, int TERMS>
int run(Params& p, int is_f32, int B, int T, int H, int D, float scale_in, float scale_out,
        int device, void* stream) {
  if (!is_f32 || D < 8 || D > 128 || D % 8 != 0 || T < 1 || B < 1 || H < 1 || B * H > 65535)
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
  const int dp = (D + 15) / 16 * 16;
  if (TERMS == 1) {  // the accuracy check's variant
    if (dp == 48) return BWD ? launch_bwd<48, 1>(p, st) : launch_fwd<48, 1>(p, st);
    if (dp == 64) return BWD ? launch_bwd<64, 1>(p, st) : launch_fwd<64, 1>(p, st);
    return -1;
  }
  switch (dp) {
    case 16: return BWD ? launch_bwd<16, 3>(p, st) : launch_fwd<16, 3>(p, st);
    case 32: return BWD ? launch_bwd<32, 3>(p, st) : launch_fwd<32, 3>(p, st);
    case 48: return BWD ? launch_bwd<48, 3>(p, st) : launch_fwd<48, 3>(p, st);
    case 64: return BWD ? launch_bwd<64, 3>(p, st) : launch_fwd<64, 3>(p, st);
    case 80: return BWD ? launch_bwd<80, 3>(p, st) : launch_fwd<80, 3>(p, st);
    case 96: return BWD ? launch_bwd<96, 3>(p, st) : launch_fwd<96, 3>(p, st);
    case 112: return BWD ? launch_bwd<112, 3>(p, st) : launch_fwd<112, 3>(p, st);
    case 128: return BWD ? launch_bwd<128, 3>(p, st) : launch_fwd<128, 3>(p, st);
    default: return -1;
  }
}

// the three planes of the fused projection qkv [B, T, 3C] (strided along
// batch and token), channels (q|k|v)-major (new_order) or head-major
void qkv_planes(Plane* planes[3], const void* qkv, int H, int D, long long stride_b,
                long long stride_t, int new_order) {
  const long long C = (long long)H * D;
  for (int j = 0; j < 3; ++j)
    *planes[j] = {const_cast<float*>(static_cast<const float*>(qkv)) + (new_order ? j * C : j * D),
                  stride_b, stride_t, new_order ? D : 3LL * D};
}

template <int TERMS>
int fwd_planes(const void* q, const void* k, const void* v, const long long* strides, void* out,
               float* lse, int is_f32, int B, int T, int H, int D, float scale, int device,
               void* stream) {
  Params p = {};
  const void* ptrs[3] = {q, k, v};
  Plane* planes[3] = {&p.q, &p.k, &p.v};
  for (int j = 0; j < 3; ++j)
    *planes[j] = {const_cast<void*>(ptrs[j]), strides[3 * j], strides[3 * j + 1],
                  strides[3 * j + 2]};
  p.out = out;
  p.lse = lse;
  return run<false, TERMS>(p, is_f32, B, T, H, D, scale, 0.f, device, stream);
}

template <int TERMS>
int bwd_planes(const void* q, const void* k, const void* v, void* dq, void* dk, void* dv,
               const long long* strides, const void* out, const void* dout, const float* lse,
               float* delta, int is_f32, int B, int T, int H, int D, float scale_in,
               float scale_out, int device, void* stream) {
  Params p = {};
  void* ptrs[6] = {const_cast<void*>(q), const_cast<void*>(k), const_cast<void*>(v),
                   dq, dk, dv};
  Plane* planes[6] = {&p.q, &p.k, &p.v, &p.dq, &p.dk, &p.dv};
  for (int j = 0; j < 6; ++j)
    *planes[j] = {ptrs[j], strides[3 * j], strides[3 * j + 1], strides[3 * j + 2]};
  p.out = const_cast<void*>(out);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  return run<true, TERMS>(p, is_f32, B, T, H, D, scale_in, scale_out, device, stream);
}

}  // namespace

// Every entry returns cudaGetLastError() after its launches (0 on success),
// or -1 for an argument it does not take: float32 only (is_f32 must be 1),
// D a multiple of 8 up to 128, B*H <= 65535. Pointers are device pointers;
// every q/k/v/dq/dk/dv row starts on 16 bytes (unit stride along D, strides
// multiples of 8 elements, 16-byte-aligned bases); out and dout are
// [B, T, H, D] contiguous, lse and delta [B*H, T] f32 (the wrappers check
// and allocate). The arguments are those of attention_fwd.cu's and
// attention_bwd.cu's entries.

// forward, q, k, v from the fused projection qkv [B, T, 3C]; lse may be null
extern "C" int eo_qkv_attention_fwd_tf32x3(const void* qkv, void* out, float* lse, int is_f32,
                                           int B, int T, int H, int D, long long stride_b,
                                           long long stride_t, int new_order, float scale,
                                           int device, void* stream) {
  Params p = {};
  Plane* planes[3] = {&p.q, &p.k, &p.v};
  qkv_planes(planes, qkv, H, D, stride_b, stride_t, new_order);
  p.out = out;
  p.lse = lse;
  return run<false, 3>(p, is_f32, B, T, H, D, scale, 0.f, device, stream);
}

// forward, q, k, v as three [B, T, H, D] tensors or views; strides holds
// their (batch, token, head) strides in elements, q's three first
extern "C" int eo_attention_fwd_tf32x3(const void* q, const void* k, const void* v,
                                       const long long* strides, void* out, float* lse,
                                       int is_f32, int B, int T, int H, int D, float scale,
                                       int device, void* stream) {
  return fwd_planes<3>(q, k, v, strides, out, lse, is_f32, B, T, H, D, scale, device, stream);
}

// backward from the fused projection: dq, dk, dv written into dqkv
// [B, T, 3C], contiguous, in qkv's head order
extern "C" int eo_qkv_attention_bwd_tf32x3(const void* qkv, const void* out, const void* dout,
                                           const float* lse, float* delta, void* dqkv,
                                           int is_f32, int B, int T, int H, int D,
                                           long long stride_b, long long stride_t,
                                           int new_order, float scale_in, float scale_out,
                                           int device, void* stream) {
  Params p = {};
  Plane* in[3] = {&p.q, &p.k, &p.v};
  Plane* grad[3] = {&p.dq, &p.dk, &p.dv};
  qkv_planes(in, qkv, H, D, stride_b, stride_t, new_order);
  qkv_planes(grad, dqkv, H, D, (long long)T * 3 * H * D, 3LL * H * D, new_order);
  p.out = const_cast<void*>(out);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  return run<true, 3>(p, is_f32, B, T, H, D, scale_in, scale_out, device, stream);
}

// backward on six [B, T, H, D] tensors or views q, k, v, dq, dk, dv;
// strides holds their (batch, token, head) strides in that order, 18 values
extern "C" int eo_attention_bwd_tf32x3(const void* q, const void* k, const void* v, void* dq,
                                       void* dk, void* dv, const long long* strides,
                                       const void* out, const void* dout, const float* lse,
                                       float* delta, int is_f32, int B, int T, int H, int D,
                                       float scale_in, float scale_out, int device,
                                       void* stream) {
  return bwd_planes<3>(q, k, v, dq, dk, dv, strides, out, dout, lse, delta, is_f32, B, T, H, D,
                       scale_in, scale_out, device, stream);
}

// The single-term (plain TF32) variants of the separate-tensor entries, D 48
// and 64 only: the accuracy check's planted fault, launched by no model path
extern "C" int eo_attention_fwd_tf32x1(const void* q, const void* k, const void* v,
                                       const long long* strides, void* out, float* lse,
                                       int is_f32, int B, int T, int H, int D, float scale,
                                       int device, void* stream) {
  return fwd_planes<1>(q, k, v, strides, out, lse, is_f32, B, T, H, D, scale, device, stream);
}

extern "C" int eo_attention_bwd_tf32x1(const void* q, const void* k, const void* v, void* dq,
                                       void* dk, void* dv, const long long* strides,
                                       const void* out, const void* dout, const float* lse,
                                       float* delta, int is_f32, int B, int T, int H, int D,
                                       float scale_in, float scale_out, int device,
                                       void* stream) {
  return bwd_planes<1>(q, k, v, dq, dk, dv, strides, out, dout, lse, delta, is_f32, B, T, H, D,
                       scale_in, scale_out, device, stream);
}
