// Self-attention at wide head dims for Hopper (sm_90a), forward and
// backward, at any sequence length, bound through ctypes.
//
// What it replaces. The TPU's flash attention pads D to a multiple of 128
// at any width: the resident forward K2 (`_resident_kernel`) and the
// grid-tiled K3 (`_flash_kernel`), both behind `_flash_fwd_impl`
// (eo_diffusion_tpu/ops/attention.py:333), and the backward K4
// (`_flash_bwd_impl`, :569). The port's attention bodies
// (attention_fwd_sm90.cu / attention_bwd_sm90.cu in bf16, the FMA kernels of
// attention_fwd.cu / attention_bwd.cu in float32) keep a query tile's output
// accumulator in registers, which caps D at 256 in bf16 and 128 in float32.
// This file takes the head dims above those, at any D that is a multiple of
// 8 and any T: inria64's middle attention (one head of D 1024) and
// eurosat64's (D 512), at T 64 (64 px), 1024 (256 px), 4096 (512 px) and
// beyond.
//
// It computes the plain version's function (ops/attention.py,
// reference_attention / reference_attention_bwd), step for step:
//
//   forward   o = softmax((q*s) (k*s)^T) v,  s = D^-1/4 rounded to the
//             input dtype, q*s and k*s rounded to it; scores and softmax in
//             float32; lse = m + log(l);
//   backward  p = exp(S - lse), delta = rowsum(do * o), dp = do v^T,
//             ds = p * (dp - delta), all float32; p and ds rounded to the
//             input dtype; dv = p^T do, dq = ds (k*s) * s', dk = ds^T (q*s)
//             * s' (s' = D^-1/4 in float32), accumulated in float32 and
//             rounded once.
// The bf16 forward keeps p to about 16 bits in the PV product (two bf16
// terms, p's rounding and its remainder), near the plain version's float32
// p; K1's bf16 body rounds p once (2^-9), which the backward of a sharp
// softmax amplifies through delta = rowsum(do * o).
//
// What bounds it. The work is 4 B H T^2 D operations forward and 10 B H
// T^2 D backward: from T about 600 (forward) and 500 (backward) up the
// tensor cores bound it (989 TFLOP/s bf16), below that the bytes of q, k, v,
// o (and do, dq, dk, dv) at 3.35 TB/s. The
// difficulty is the accumulator: 64 rows of float32 output at D 1024 take
// 256 KiB, the whole register file of an SM.
//
// Design: every product is one of two shapes, and one kernel template runs
// all four jobs (the forward, and dq, dk, dv of the backward):
//
//   X = A B^T over D           (64 rows x a 64-column tile; D streamed in
//                               chunks of 64 through shared memory)
//   W = f(X, X2, row or column statistics)     (elementwise, in registers)
//   O[:, chunk] += W C[:, chunk]               (the CTA's DC output columns)
//
//   job     rows     columns   X (X2)              W                         C        O
//   fwd     queries  keys      q k^T               online softmax of X      v        o
//   dq      queries  keys      q k^T (do v^T)      ds, lse and delta by row  k*s      dq
//   dk      keys     queries   k q^T (v do^T)      ds^T, by column           q*s      dk
//   dv      keys     queries   k q^T               p^T, by column            do       dv
//
// A CTA owns 64 rows (16 a warp) and one chunk of DC output columns, and
// streams the column tiles (keys, or queries in the key-side jobs) in
// order; the grid is ceil(T/64) x B*H x ceil(D/DC). The CTAs of a row block
// split D between them: a thread-block cluster of
// the ceil(D/DC) <= 8 CTAs, each running the score products over its own
// DC columns of D only, then summing the partial tiles through distributed
// shared memory: each CTA stores its partial of an entry into the shared
// memory of the CTA that owns the entry, the owner sums them in rank order
// and stores the sum into every CTA's (remote stores only, two cluster
// barriers a tile), so every CTA holds the same X and no product is done
// twice. Where a cluster would not fill the card
// (e.g. B8 T64 H1 D1024) or would need more than 8 CTAs, each CTA instead
// runs the score products over all of D (ceil(D/DC) times the score work)
// with DC as narrow as 64 so that more CTAs run. DC is as wide
// as the job's registers allow (256 for the forward and dv, 128 for dq and
// dk, which hold X2 too) where the grid still fills the card.
//
// The backward launches a delta kernel (rowsum(do * o) into a [B*H, T]
// float32 buffer), then the dq, dk and dv jobs; P is recomputed from the
// saved lse, so no [T, T] buffer exists in device memory, and every output
// element is written once by one CTA: no atomics, the same bits on every
// run.
//
// bf16 (kernel `wide_mma`): 4 warps, m16n8k16 mma.sync on the tensor cores
// (HMMA) with float32 accumulators, ldmatrix operands, a cp.async ring of
// score chunks (3 stages; 2 in a cluster or where the job has a second score
// product), q*s and k*s rounded in shared memory by the thread that copied
// the piece (fma.rn.bf16x2, one rounding as PyTorch's bf16 product), W
// turned into A fragments in registers (FlashAttention-2's trick). float32
// (kernel `wide_fma`): the same jobs and order on the FMA units (TF32 stays
// off), each CTA over all of D, 16 rows and 128 output columns a CTA of 256
// threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mma_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using eo_tile::cp_async16;
using eo_tile::cp_async_commit;
using eo_tile::cp_async_wait;

enum Job { kFwd = 0, kDq = 1, kDk = 2, kDv = 3 };

constexpr int kTile = 64;  // rows a CTA (bf16), columns a tile, head dims a score chunk
constexpr int kLd = kTile + 8;  // row stride of a chunk in shared memory (bank groups apart)
constexpr int kMmaThreads = 128;
constexpr int kMaxSplit = 8;  // CTAs a cluster at most (the portable limit)
constexpr float kLog2e = 1.4426950408889634f;

// element (b, t, h, d) of a plane sits at ptr + b*sb + t*st + h*sh + d
struct Plane {
  const void* ptr;
  long long sb, st, sh;
};

struct Args {
  Plane a1, b1;   // X = a1 b1^T (rows x columns)
  Plane a2, b2;   // X2 = a2 b2^T (dq, dk)
  Plane c;        // the output product's right operand, by column index
  void* out;      // [B, T, H, D] contiguous
  float* lse;     // [B*H, T]: written by the forward (may be null), read by the rest
  const float* delta;  // [B*H, T] (dq, dk)
  int T, H, D;
  float s_in;     // D^-1/4 rounded to the input dtype
  float sc;       // the output's factor (dq, dk), D^-1/4 in float32
};

// dq and dk: a second score product (dP), and a scaled C (k*s, q*s)
__host__ __device__ constexpr bool two_products(int job) { return job == kDq || job == kDk; }
__host__ __device__ constexpr bool column_stats(int job) { return job == kDk || job == kDv; }

template <typename T>
__device__ __forceinline__ const T* head(const Plane& p, int b, int h) {
  return static_cast<const T*>(p.ptr) + b * p.sb + h * p.sh;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

// a * b on two bf16 pairs, rounded once to nearest even (-0 added)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

__device__ __forceinline__ void scale16(bf16* p, uint32_t s2) {
  uint4 v = *reinterpret_cast<uint4*>(p);
  v.x = mul_bf16x2(v.x, s2);
  v.y = mul_bf16x2(v.y, s2);
  v.z = mul_bf16x2(v.z, s2);
  v.w = mul_bf16x2(v.w, s2);
  *reinterpret_cast<uint4*>(p) = v;
}

// rows [i0, i0 + 64) x dims [d0, d0 + W) of a plane into dst (row stride
// ld), 16 bytes a copy, zero outside T and D. Piece e = threadIdx.x + i *
// kMmaThreads is this thread's; scale_tile rounds the same pieces to (x*s)
// once they have landed
template <int W>
__device__ __forceinline__ void copy_tile(bf16* dst, int ld, const bf16* base, long long st,
                                          int i0, int d0, int Tn, int D) {
  constexpr int kPer = kTile * W / 8 / kMmaThreads;
  static_assert(kTile * W / 8 % kMmaThreads == 0, "whole pieces a thread");
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kMmaThreads;
    const int r = e / (W / 8), c8 = (e % (W / 8)) * 8, i = i0 + r, d = d0 + c8;
    const bool in = i < Tn && d < D;
    cp_async16(dst + r * ld + c8, in ? base + i * st + d : base, in);
  }
}

template <int W>
__device__ __forceinline__ void scale_tile(bf16* dst, int ld, uint32_t s2) {
  constexpr int kPer = kTile * W / 8 / kMmaThreads;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kMmaThreads;
    scale16(dst + (e / (W / 8)) * ld + (e % (W / 8)) * 8, s2);
  }
}

// x += the warp's 16 rows of at (64 x 64, [row][d]) times bt^T (64 x 64,
// [column][d]): 16 x 64, x[n] the n-th 8 columns
__device__ __forceinline__ void score_chunk(float (&x)[8][4], const bf16* at, const bf16* bt,
                                            int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t af[4];
    eo_tile::load_a<false>(af, at + (16 * warp) * kLd + kk * 16, kLd, lane);
#pragma unroll
    for (int n2 = 0; n2 < kTile / 16; ++n2) {
      uint32_t bfr[2][2];
      eo_tile::load_b2<false>(bfr, bt + (n2 * 16) * kLd + kk * 16, kLd, lane);
      eo_tile::mma_bf16(x[2 * n2], af, bfr[0][0], bfr[0][1]);
      eo_tile::mma_bf16(x[2 * n2 + 1], af, bfr[1][0], bfr[1][1]);
    }
  }
}

// kSplit: the CTAs of a cluster (one a DC-column chunk of D) each run the
// score products over their own chunk only and sum the partial tiles
// through distributed shared memory; else each runs them over all of D
template <int Job, int DC, bool kSplit>
struct MmaShape {
  static constexpr int kOps = two_products(Job) ? 4 : 2;  // chunks a stage
  static constexpr int kStages = two_products(Job) || kSplit ? 2 : 3;
  static constexpr int kLdc = DC + 8;
  static constexpr int kStage = kOps * kTile * kLd;  // elements
  // a partial score tile: float4 (warp, 8-column group, lane), 16 KiB; the
  // partials of the entries this CTA sums (padded by a rank), then the sums
  static constexpr int kPart = kTile * kTile / 4;
  static constexpr int kParts = kSplit ? 2 * (kOps / 2) : 0;
  static constexpr size_t kSmem = sizeof(bf16) * (kStages * kStage + kTile * kLdc) +
                                   sizeof(float4) * (kParts * kPart + (kSplit ? kMaxSplit : 0));
};

template <int Job, int DC, bool kSplit>
__global__ void __launch_bounds__(kMmaThreads) wide_mma(Args a) {
  using S = MmaShape<Job, DC, kSplit>;
  constexpr bool kTwo = two_products(Job);
  constexpr int kNs = S::kStages, kLdc = S::kLdc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* ct = ring + kNs * S::kStage;
  float4* parts = reinterpret_cast<float4*>(ct + kTile * kLdc);

  const int Tn = a.T, D = a.D;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int r0 = blockIdx.x * kTile, d0 = blockIdx.z * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  // the score products' head dims: this CTA's chunk, or all of D
  const int dlo = kSplit ? d0 : 0, dhi = kSplit ? min(D, d0 + DC) : D;
  const int nd = (dhi - dlo + kTile - 1) / kTile, ncb = (Tn + kTile - 1) / kTile;
  const int steps = nd * ncb;
  const bf16 sb = __float2bfloat16(a.s_in);
  const uint32_t s2 = (uint32_t)__bfloat16_as_ushort(sb) * 0x10001u;
  const bf16 *pa1 = head<bf16>(a.a1, b, h), *pb1 = head<bf16>(a.b1, b, h);
  const bf16 *pa2 = head<bf16>(a.a2, b, h), *pb2 = head<bf16>(a.b2, b, h);
  const bf16* pc = head<bf16>(a.c, b, h);
  const float* lse_bh = a.lse + (long long)bh * Tn;
  const float* delta_bh = a.delta + (long long)bh * Tn;

  auto load_stage = [&](int s) {
    const int cb = s / nd, dc = dlo + (s - cb * nd) * kTile;
    bf16* st = ring + (s % kNs) * S::kStage;
    copy_tile<kTile>(st, kLd, pa1, a.a1.st, r0, dc, Tn, D);
    copy_tile<kTile>(st + kTile * kLd, kLd, pb1, a.b1.st, cb * kTile, dc, Tn, D);
    if (kTwo) {
      copy_tile<kTile>(st + 2 * kTile * kLd, kLd, pa2, a.a2.st, r0, dc, Tn, D);
      copy_tile<kTile>(st + 3 * kTile * kLd, kLd, pb2, a.b2.st, cb * kTile, dc, Tn, D);
    }
  };

  // this warp's rows: r0 + 16 warp + g (index 0) and + 8 (index 1)
  const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
  float stat_l[2] = {0.f, 0.f}, stat_d[2] = {0.f, 0.f};  // dq: lse and delta by row
  if (Job == kDq) {
    if (row_a < Tn) stat_l[0] = lse_bh[row_a], stat_d[0] = delta_bh[row_a];
    if (row_b < Tn) stat_l[1] = lse_bh[row_b], stat_d[1] = delta_bh[row_b];
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // forward's running max and sum
  float o[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float x1[8][4], x2[8][4];

#pragma unroll
  for (int s = 0; s < kNs - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int cb = s / nd, c = s - cb * nd;
    bf16* st = ring + (s % kNs) * S::kStage;
    cp_async_wait<kNs - 2>();
    scale_tile<kTile>(st, kLd, s2);  // q*s and k*s, this thread's pieces
    scale_tile<kTile>(st + kTile * kLd, kLd, s2);
    __syncthreads();
    if (c == 0) {  // this column tile's C chunk: its buffer was last read before the barrier
      copy_tile<DC>(ct, kLdc, pc, a.c.st, cb * kTile, d0, Tn, D);
      cp_async_commit();
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) x1[n][j] = x2[n][j] = 0.f;
    }
    if (s + kNs - 1 < steps) load_stage(s + kNs - 1);
    cp_async_commit();

    // X (and X2) += this chunk of the score products
    score_chunk(x1, st, st + kTile * kLd, warp, lane);
    if (kTwo) score_chunk(x2, st + 2 * kTile * kLd, st + 3 * kTile * kLd, warp, lane);
    if (c != nd - 1) continue;

    // the C chunk: groups committed after it are the nd step groups since
    if (nd >= kNs - 1)
      cp_async_wait<kNs - 1>();
    else
      cp_async_wait<0>();
    if (kTwo) scale_tile<DC>(ct, kLdc, s2);
    __syncthreads();
    if (kSplit) {
      // X (and X2) = the sum of the cluster's partial tiles. Entry e (of a
      // tile in fragment order) belongs to rank e % ranks: every CTA stores
      // its partial of e into the owner's shared memory, the owner sums the
      // ranks' partials in rank order and stores the sum into every CTA's
      // shared memory, and each CTA reads its tile back locally. Remote
      // accesses are stores only (posted), two cluster barriers a tile
      cg::cluster_group cluster = cg::this_cluster();
      const int ranks = static_cast<int>(cluster.num_blocks());
      const int rank = static_cast<int>(cluster.block_rank());
      constexpr int kP = kTwo ? 2 * S::kPart : S::kPart;
      const int per = (kP + ranks - 1) / ranks;  // entries a rank owns, at most
      float4* recv = parts;                    // [ranks][per]: partials of my entries
      float4* full = parts + kP + kMaxSplit;   // [kP]: the summed tile
      const int at = (warp * 8) * 32 + lane;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int e = at + n * 32;
        cluster.map_shared_rank(recv, e % ranks)[rank * per + e / ranks] =
            make_float4(x1[n][0], x1[n][1], x1[n][2], x1[n][3]);
        if (kTwo) {
          const int e2 = S::kPart + e;
          cluster.map_shared_rank(recv, e2 % ranks)[rank * per + e2 / ranks] =
              make_float4(x2[n][0], x2[n][1], x2[n][2], x2[n][3]);
        }
      }
      cluster.sync();  // every partial delivered
      for (int i = threadIdx.x; i * ranks + rank < kP; i += kMmaThreads) {
        float4 acc = recv[i];
        for (int r = 1; r < ranks; ++r) {
          const float4 u = recv[r * per + i];
          acc.x += u.x, acc.y += u.y, acc.z += u.z, acc.w += u.w;
        }
        for (int r = 0; r < ranks; ++r) cluster.map_shared_rank(full, r)[i * ranks + rank] = acc;
      }
      cluster.sync();  // every sum delivered (and every partial read)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 u = full[at + n * 32];
        x1[n][0] = u.x, x1[n][1] = u.y, x1[n][2] = u.z, x1[n][3] = u.w;
        if (kTwo) {
          const float4 w = full[S::kPart + at + n * 32];
          x2[n][0] = w.x, x2[n][1] = w.y, x2[n][2] = w.z, x2[n][3] = w.w;
        }
      }
    }
    // W in registers: x1[n][j] is (row g + 8 (j / 2), column 8 n + 2 t4 + j % 2)
    const int col0 = cb * kTile + 2 * t4;
    if (Job == kFwd) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col0 + 8 * n + (j & 1) >= Tn) x1[n][j] = -INFINITY;
          mx[j >> 1] = fmaxf(mx[j >> 1], x1[n][j]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = eo_tile::ex2((m[i] - mx[i]) * kLog2e);
        m[i] = mx[i];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x1[n][j] = eo_tile::ex2((x1[n][j] - m[j >> 1]) * kLog2e);
          sum[j >> 1] += x1[n][j];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * n + e;
          const bool in = col < Tn;
          float cl = 0.f, cd = 0.f;
          if (column_stats(Job) && in) {
            cl = lse_bh[col];
            if (Job == kDk) cd = delta_bh[col];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = 2 * i + e;
            const float lse_v = column_stats(Job) ? cl : stat_l[i];
            const float p = in ? eo_tile::ex2((x1[n][j] - lse_v) * kLog2e) : 0.f;
            if (Job == kDv) {
              x1[n][j] = p;
            } else {
              const float dl = column_stats(Job) ? cd : stat_d[i];
              x1[n][j] = p * (x2[n][j] - dl);
            }
          }
        }
    }

    // O += W C: the backward's W (ds, or p) rounded to bf16 as the plain
    // version rounds it; the forward's p as two bf16 terms, p's rounding and
    // what it left, so that PV keeps p to about 16 bits as the plain
    // version's float32 product does (a p rounded once moves o by up to 2^-9
    // and the backward's delta = rowsum(do * o) with it)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t af[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float(&w)[4] = x1[2 * kk + (q >> 1)];
        const int j = 2 * (q & 1);
        af[q] = eo_tile::pack_bf16(w[j], w[j + 1]);
        if (Job == kFwd) {
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&af[q]));
          lo[q] = eo_tile::pack_bf16(w[j] - hi.x, w[j + 1] - hi.y);
        }
      }
#pragma unroll
      for (int n2 = 0; n2 < DC / 16; ++n2) {
        uint32_t bfr[2][2];
        eo_tile::load_b2<true>(bfr, ct + (kk * 16) * kLdc + n2 * 16, kLdc, lane);
        eo_tile::mma_bf16(o[2 * n2], af, bfr[0][0], bfr[0][1]);
        eo_tile::mma_bf16(o[2 * n2 + 1], af, bfr[1][0], bfr[1][1]);
        if (Job == kFwd) {
          eo_tile::mma_bf16(o[2 * n2], lo, bfr[0][0], bfr[0][1]);
          eo_tile::mma_bf16(o[2 * n2 + 1], lo, bfr[1][0], bfr[1][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  // no CTA leaves while the others of its cluster may still read its tiles
  if (kSplit) cg::this_cluster().sync();

  float f[2] = {a.sc, a.sc};
  if (Job == kFwd) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      f[i] = 1.f / l[i];
    }
    if (a.lse != nullptr && blockIdx.z == 0 && t4 == 0) {
      if (row_a < Tn) a.lse[(long long)bh * Tn + row_a] = m[0] + logf(l[0]);
      if (row_b < Tn) a.lse[(long long)bh * Tn + row_b] = m[1] + logf(l[1]);
    }
  } else if (Job == kDv) {
    f[0] = f[1] = 1.f;
  }
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_a : row_b;
    if (row >= Tn) continue;
    bf16* orow = out + (((long long)b * Tn + row) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const int d = d0 + 8 * n + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(o[n][2 * i] * f[i], o[n][2 * i + 1] * f[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA units

constexpr int kFmaThreads = 256;
constexpr int kFRows = 16;   // rows a CTA
constexpr int kFDc = 128;    // output columns a CTA
constexpr int kFHalf = 64;   // output columns a C tile in shared memory
constexpr int kFChunk = 32;  // head dims a score chunk

// rows x kFChunk tile of plane rows [i0, i0 + rows), dims [d0, d0 + kFChunk),
// times s when kScaled (float32: q*s in float32); zero outside T and D
template <int kRowsT, int kW, bool kScaled>
__device__ __forceinline__ void load_f32(float (*dst)[kW + 1], const float* base, long long st,
                                         int i0, int d0, int Tn, int D, float s) {
  for (int e = threadIdx.x; e < kRowsT * kW; e += kFmaThreads) {
    const int r = e / kW, c = e % kW, i = i0 + r, d = d0 + c;
    float x = 0.f;
    if (i < Tn && d < D) {
      x = base[i * st + d];
      if (kScaled) x *= s;
    }
    dst[r][c] = x;
  }
}

template <int Job>
__global__ void __launch_bounds__(kFmaThreads) wide_fma(Args a) {
  constexpr bool kTwo = two_products(Job);
  __shared__ float at1[kFRows][kFChunk + 1], at2[kFRows][kFChunk + 1];
  __shared__ float bt1[kTile][kFChunk + 1], bt2[kTile][kFChunk + 1];
  __shared__ float w[kFRows][kTile + 1];
  __shared__ float ct[kTile][kFHalf + 1];
  const int Tn = a.T, D = a.D;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int r0 = blockIdx.x * kFRows, d0 = blockIdx.z * kFDc;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15, row = r0 + r;
  const float *pa1 = head<float>(a.a1, b, h), *pb1 = head<float>(a.b1, b, h);
  const float *pa2 = head<float>(a.a2, b, h), *pb2 = head<float>(a.b2, b, h);
  const float* pc = head<float>(a.c, b, h);
  const float* lse_bh = a.lse + (long long)bh * Tn;
  const float* delta_bh = a.delta + (long long)bh * Tn;
  float stat_l = 0.f, stat_d = 0.f;
  if (Job == kDq && row < Tn) stat_l = lse_bh[row], stat_d = delta_bh[row];
  float m = -INFINITY, l = 0.f;
  float o[kFDc / 16];
#pragma unroll
  for (int j = 0; j < kFDc / 16; ++j) o[j] = 0.f;

  for (int j0 = 0; j0 < Tn; j0 += kTile) {
    float x1[4] = {0.f, 0.f, 0.f, 0.f}, x2[4] = {0.f, 0.f, 0.f, 0.f};
    for (int dc = 0; dc < D; dc += kFChunk) {
      load_f32<kFRows, kFChunk, true>(at1, pa1, a.a1.st, r0, dc, Tn, D, a.s_in);
      load_f32<kTile, kFChunk, true>(bt1, pb1, a.b1.st, j0, dc, Tn, D, a.s_in);
      if (kTwo) {
        load_f32<kFRows, kFChunk, false>(at2, pa2, a.a2.st, r0, dc, Tn, D, 0.f);
        load_f32<kTile, kFChunk, false>(bt2, pb2, a.b2.st, j0, dc, Tn, D, 0.f);
      }
      __syncthreads();
#pragma unroll 8
      for (int x = 0; x < kFChunk; ++x) {
        const float u = at1[r][x];
#pragma unroll
        for (int q = 0; q < 4; ++q) x1[q] = fmaf(u, bt1[c + 16 * q][x], x1[q]);
        if (kTwo) {
          const float u2 = at2[r][x];
#pragma unroll
          for (int q = 0; q < 4; ++q) x2[q] = fmaf(u2, bt2[c + 16 * q][x], x2[q]);
        }
      }
      __syncthreads();
    }

    // W: the 16 threads of a row are 16 consecutive lanes of one warp
    if (Job == kFwd) {
      float mx = m;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (j0 + c + 16 * q >= Tn) x1[q] = -INFINITY;
        mx = fmaxf(mx, x1[q]);
      }
#pragma unroll
      for (int o2 = 8; o2; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float alpha = expf(m - mx);
      m = mx;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x1[q] = expf(x1[q] - m);
        sum += x1[q];
      }
#pragma unroll
      for (int o2 = 8; o2; o2 >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      l = l * alpha + sum;
#pragma unroll
      for (int j = 0; j < kFDc / 16; ++j) o[j] *= alpha;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = j0 + c + 16 * q;
        if (col >= Tn) {
          x1[q] = 0.f;
          continue;
        }
        const float lse_v = column_stats(Job) ? lse_bh[col] : stat_l;
        const float p = expf(x1[q] - lse_v);
        if (Job == kDv) {
          x1[q] = p;
        } else {
          const float dl = column_stats(Job) ? delta_bh[col] : stat_d;
          x1[q] = p * (x2[q] - dl);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) w[r][c + 16 * q] = x1[q];

#pragma unroll
    for (int half = 0; half < kFDc / kFHalf; ++half) {
      load_f32<kTile, kFHalf, kTwo>(ct, pc, a.c.st, j0, d0 + half * kFHalf, Tn, D, a.s_in);
      __syncthreads();
#pragma unroll 8
      for (int x = 0; x < kTile; ++x) {
        const float u = w[r][x];
#pragma unroll
        for (int q = 0; q < 4; ++q) o[half * 4 + q] = fmaf(u, ct[x][c + 16 * q], o[half * 4 + q]);
      }
      __syncthreads();
    }
  }

  float f = Job == kDv ? 1.f : a.sc;
  if (Job == kFwd) {
    f = 1.f / l;
    if (a.lse != nullptr && blockIdx.z == 0 && c == 0 && row < Tn)
      a.lse[(long long)bh * Tn + row] = m + logf(l);
  }
  if (row >= Tn) return;
  float* orow = static_cast<float*>(a.out) + (((long long)b * Tn + row) * a.H + h) * D;
#pragma unroll
  for (int half = 0; half < kFDc / kFHalf; ++half)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = d0 + half * kFHalf + c + 16 * q;
      if (d < D) orow[d] = o[half * 4 + q] * f;
    }
}

// ---------------------------------------------------------------------------
// delta = rowsum(do * o), float32, one warp a row of [B*H, T]

template <typename T>
__device__ __forceinline__ float ldf(const T* p, long long i);
template <>
__device__ __forceinline__ float ldf<float>(const float* p, long long i) {
  return p[i];
}
template <>
__device__ __forceinline__ float ldf<bf16>(const bf16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(256) wide_delta(const T* __restrict__ out,
                                                  const T* __restrict__ dout,
                                                  float* __restrict__ delta, int Tn, int H, int D,
                                                  long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long bh = row / Tn, t = row % Tn, b = bh / H, h = bh % H;
  const long long base = ((b * Tn + t) * H + h) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(ldf<T>(dout, base + d), ldf<T>(out, base + d), acc);
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// launches

int check(int B, int T, int H, int D, int device) {
  if (B < 1 || H < 1 || T < 1 || D < 8 || D % 8 || (long long)B * H > 65535) return -1;
  const cudaError_t set = cudaSetDevice(device);
  return set == cudaSuccess ? 0 : static_cast<int>(set);
}

constexpr int kMaxDevices = 64;  // the per-device host caches below

int sm_count(int device) {
  static int cached[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && cached[device] > 0) return cached[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) n = 132;
  if (device >= 0 && device < kMaxDevices) cached[device] = n;
  return n;
}

template <int Job, int DC, bool kSplit>
int launch_mma(const Args& a, int B, int device, cudaStream_t st) {
  const size_t smem = MmaShape<Job, DC, kSplit>::kSmem;
  const auto kernel = wide_mma<Job, DC, kSplit>;
  static bool ready[kMaxDevices] = {};  // the shared-memory limit, set once a device
  cudaError_t e = cudaSuccess;
  if (device < 0 || device >= kMaxDevices || !ready[device]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device >= 0 && device < kMaxDevices) ready[device] = true;
  }
  const unsigned chunks = (a.D + DC - 1) / DC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.T + kTile - 1) / kTile, B * a.H, chunks);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = kSplit ? chunks : 1;  // a row block's chunks of D
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The output chunk DC (up to kMax, the job's register limit) and the mode:
// the widest DC whose grid fills the card with D split over a cluster of
// ceil(D / DC) <= kMaxSplit CTAs; else each CTA runs the score products
// over all of D, at the widest DC that fills the card (64 if none does).
template <int Job, int kMax>
int run_mma(const Args& a, int B, int device, cudaStream_t st) {
  const int sms = sm_count(device);
  const long long blocks = (long long)((a.T + kTile - 1) / kTile) * B * a.H;
  const auto chunks = [&](int dc) { return (a.D + dc - 1) / dc; };
  const auto fills = [&](int dc) { return blocks * chunks(dc) >= sms; };
  if constexpr (kMax >= 256) {
    if (chunks(256) <= kMaxSplit && fills(256))
      return launch_mma<Job, 256, true>(a, B, device, st);
  }
  if (chunks(128) <= kMaxSplit && fills(128))
    return launch_mma<Job, 128, true>(a, B, device, st);
  if constexpr (kMax >= 256) {
    if (fills(256)) return launch_mma<Job, 256, false>(a, B, device, st);
  }
  if (fills(128)) return launch_mma<Job, 128, false>(a, B, device, st);
  return launch_mma<Job, 64, false>(a, B, device, st);
}

template <int Job>
int run_fma(const Args& a, int B, cudaStream_t st) {
  const dim3 grid((a.T + kFRows - 1) / kFRows, B * a.H, (a.D + kFDc - 1) / kFDc);
  wide_fma<Job><<<grid, kFmaThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Plane plane(const void* ptr, const long long* s) { return {ptr, s[0], s[1], s[2]}; }

}  // namespace

// Both entries return cudaGetLastError() after the launches (0 on success),
// or -1 for an argument the kernels do not take (D not a multiple of 8, B*H
// beyond the grid). Pointers are device pointers; q, k and v are three
// [B, T, H, D] tensors or views, strides holding their (batch, token, head)
// strides in elements, q's three first, each with unit stride along D;
// bf16 rows must start on 16 bytes (strides multiples of 8, aligned bases).
// s_in is D^-1/4 rounded to the input dtype, sc the same in float32.

// out [B, T, H, D] contiguous; lse, when not null, [B*H, T] float32
extern "C" int eo_attention_wide_fwd(const void* q, const void* k, const void* v,
                                     const long long* strides, void* out, float* lse,
                                     int is_f32, int B, int T, int H, int D, float s_in,
                                     int device, void* stream) {
  const int rc = check(B, T, H, D, device);
  if (rc != 0) return rc;
  const Plane none{nullptr, 0, 0, 0};
  const Args a{plane(q, strides), plane(k, strides + 3), none, none, plane(v, strides + 6),
               out, lse, nullptr, T, H, D, s_in, 1.f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? run_fma<kFwd>(a, B, st) : run_mma<kFwd, 256>(a, B, device, st);
}

// out, dout, dq, dk, dv [B, T, H, D] contiguous; lse [B*H, T] float32 from
// the forward; delta [B*H, T] float32 scratch
extern "C" int eo_attention_wide_bwd(const void* q, const void* k, const void* v,
                                     const long long* strides, const void* out,
                                     const void* dout, const float* lse, void* dq, void* dk,
                                     void* dv, float* delta, int is_f32, int B, int T, int H,
                                     int D, float s_in, float sc, int device, void* stream) {
  const int rc = check(B, T, H, D, device);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * H * T;
  const unsigned blocks = static_cast<unsigned>((rows + 7) / 8);
  if (is_f32)
    wide_delta<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(out),
                                              static_cast<const float*>(dout), delta, T, H, D,
                                              rows);
  else
    wide_delta<bf16><<<blocks, 256, 0, st>>>(static_cast<const bf16*>(out),
                                             static_cast<const bf16*>(dout), delta, T, H, D,
                                             rows);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  const long long ds[3] = {(long long)T * H * D, (long long)H * D, D};  // do: contiguous
  const Plane pq = plane(q, strides), pk = plane(k, strides + 3), pv = plane(v, strides + 6);
  const Plane pdo = plane(dout, ds), none{nullptr, 0, 0, 0};
  float* lse_rw = const_cast<float*>(lse);  // read only by these jobs
  const Args aq{pq, pk, pdo, pv, pk, dq, lse_rw, delta, T, H, D, s_in, sc};
  const Args ak{pk, pq, pv, pdo, pq, dk, lse_rw, delta, T, H, D, s_in, sc};
  const Args av{pk, pq, none, none, pdo, dv, lse_rw, delta, T, H, D, s_in, 1.f};
  if (is_f32) {
    if ((e = run_fma<kDq>(aq, B, st)) != 0) return e;
    if ((e = run_fma<kDk>(ak, B, st)) != 0) return e;
    return run_fma<kDv>(av, B, st);
  }
  if ((e = run_mma<kDq, 128>(aq, B, device, st)) != 0) return e;
  if ((e = run_mma<kDk, 128>(ak, B, device, st)) != 0) return e;
  return run_mma<kDv, 256>(av, B, device, st);
}
