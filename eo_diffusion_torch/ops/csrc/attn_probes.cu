// The attention probes for Hopper (sm_90a), bound through ctypes: three
// kernels with a plain C interface.
//
// 1. eo_matmul_probe replaces the body of `_bench` (tools/probe_attn_matmuls.py:38,
//    pallas_call :45): per cell of [BH], out = NK * (A B) with bf16 inputs
//    and f32 output, in the probe's three contraction layouts
//      NT  a [M, K], b [N, K]: a b^T   (QK^T)
//      NN  a [M, K], b [K, N]: a b     (PV)
//      TN  a [K, M], b [K, N]: a^T b   (the transposed PV)
//    Both NK products are computed (the K loop runs NK times into one f32
//    accumulator), as the TPU kernel computes and adds them.
//    Bound on the H100: at the probe's QK^T (BH 64, 512 x 2048, D 48, NK 2) a
//    launch does 12.9 GFLOP (0.013 ms at 989 TFLOP/s) but writes an f32
//    [64, 512, 2048] output, 268 MB (0.080 ms at 3.35 TB/s): bytes. The PV
//    forms do the same 12.9 GFLOP and read the bf16 p [64, 512, 2048], 134 MB
//    (0.040 ms): bytes too. Every form prices the traffic of its
//    materialised [512, 2048] operand more than its products.
//    Design: one block of 4 warps per 64 x 64 output tile of a cell, each
//    warp 32 x 32; A and B 32-deep k slices double-buffered through shared
//    memory with cp.async, stored in the operand's own order (mma_tile.cuh:
//    k inner or k outer, so a transposed operand costs nothing), mma.sync
//    m16n8k16 bf16. The same tile code as the conv weight-gradient kernel.
//
// 2. eo_attention_fwd_transposed replaces `kern_transposed`
//    (tools/probe_packed_pv.py:52, launched by `transposed_attn` :86, call
//    :88): o [B, H, D, T] = softmax((q s)(k s)^T) v from qkv5 [B, 3, H, T, D],
//    s = D^-1/4 rounded to the input dtype, softmax statistics in f32, p
//    rounded to the input dtype before PV, o in the input dtype.
//    Bound on the H100: at B 8, T 4096, H 8, D 48 bf16 it is 206 GFLOP (0.2085
//    ms) against 100 MB: operations, the same as K1's row.
//    Design (simple; the TPU kernel's reason for the transposed output, the
//    128-lane padding of D 48, does not exist here): one block per (b, h,
//    64-query tile), four warps of 16 query rows; K/V tiles of 64 keys
//    double-buffered with cp.async; QK^T and PV on mma.sync with an online
//    softmax in base 2 (K1's recipe); the epilogue normalises, stages the
//    [64, D] tile transposed in shared memory and writes D rows of 64
//    contiguous tokens. Any T (the ragged tail masked), D a multiple of 8 up
//    to 128. f32 inputs take an FMA kernel, one thread per query row, whose
//    transposed stores are coalesced as they stand.
//
// 3. eo_attention_hybrid replaces `kern_hybrid` and `kern_hybrid2`
//    (tools/probe_softmax_orient.py:117 / :205, launched by `hybrid_attn`
//    :153 / `hybrid2_attn` :238, calls :155 / :240): the function of 2, with
//    the same numerics, computed the hybrids' way round: S = (q s)(k s)^T with
//    the softmax statistics along its rows, then PV transposed, acc^T [D, bq]
//    = V^T P^T, so the accumulator already holds the output's [D, T]
//    orientation and no epilogue transpose is left. bf16 only (the TPU probe
//    is bf16 only).
//    Bound on the H100: 206 GFLOP at B 8, T 4096, H 8, D 48 (0.2085 ms,
//    operations), as for 2.
//    Design: K1's tiling (4 warps, 32 query rows a warp for D <= 64, else 16;
//    K/V stages of 64 keys (128 or 256 for the probe's sweep at D <= 64),
//    double-buffered with cp.async;
//    scores in register tiles of 64 keys). V [key][d] in shared memory is the
//    k-outer A operand of PV^T (ldmatrix.trans), and each V fragment feeds
//    2 MT products, as many as K1's. Two ways to hand p to the B operand:
//    p_smem 1 (kern_hybrid's explicit transpose) writes p [query][key] into
//    the warp's own shared tile and reads it back with ldmatrix; p_smem 0
//    (kern_hybrid2's contraction on dim 1) needs no move at all, since the
//    m16n8 score fragment a thread holds (query g, keys 2 tq, 2 tq + 1) is
//    the k16 x n8 B fragment of P^T. The price of the orientation: the
//    running max and sum belong to a thread's query rows, the acc^T columns
//    to other lanes, so each rescale factor and each 1/l crosses the warp by
//    one shuffle per column pair. The epilogue stores pairs of tokens
//    straight from the accumulators.
//
// 2 and 3 copy K1's loop (csrc/attention_fwd.cu), not K1's code: a change to
// K1's loop is ported here by hand and the copies re-timed against K1 before
// a comparison with K1 is read from them (ROADMAP queue 2, item 3a).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace eo_tile;

// ---------------------------------------------------------------- matmul probe

constexpr int kPM = 64, kPN = 64, kPK = 32;  // block tile and k slice
constexpr int kPThreads = 128;                // 4 warps, 2 x 2 of 32 x 32
constexpr int kPTile = 64 * 40;               // elements of one operand slice, either order

// element (r, k) of an operand slice, r the m or n index: stored k outer
// ([k][r], rows of kPM + 8) or k inner ([r][k], rows of kPK + 8)
template <bool K_OUTER>
__device__ __forceinline__ int slice_at(int r, int k) {
  return K_OUTER ? k * (kPM + 8) + r : r * (kPK + 8) + k;
}

// issue the copies of rows [r0, r0 + 64) x k [k0, k0 + 32) of one operand
// (rows = M or N); the operand is [R, K] (k inner) or [K, R] (k outer)
template <bool K_OUTER>
__device__ __forceinline__ void issue_slice(__nv_bfloat16* dst, const __nv_bfloat16* src, int R,
                                            int K, int r0, int k0) {
  for (int i = threadIdx.x; i < 256; i += kPThreads) {
    int r, k;
    if (K_OUTER) {
      k = i >> 3;
      r = (i & 7) * 8;
    } else {
      r = i >> 2;
      k = (i & 3) * 8;
    }
    const bool in = r0 + r < R && k0 + k < K;
    const long long off = K_OUTER ? (long long)(k0 + k) * R + r0 + r
                                  : (long long)(r0 + r) * K + k0 + k;
    cp_async16(dst + slice_at<K_OUTER>(r, k), in ? src + off : src, in);
  }
}

template <bool A_KO, bool B_KO>
__global__ void __launch_bounds__(kPThreads) matmul_probe(const __nv_bfloat16* __restrict__ a,
                                                          const __nv_bfloat16* __restrict__ b,
                                                          float* __restrict__ out, int M, int N,
                                                          int K, int NK) {
  __shared__ __align__(16) __nv_bfloat16 smem[2][2][kPTile];  // [stage][A, B]
  const int tiles_n = (N + kPN - 1) / kPN;
  const int m0 = (blockIdx.x / tiles_n) * kPM, n0 = (blockIdx.x % tiles_n) * kPN;
  const long long cell = blockIdx.y;
  a += cell * M * K;
  b += cell * N * K;
  out += cell * M * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  constexpr int lda = A_KO ? kPM + 8 : kPK + 8, ldb = B_KO ? kPN + 8 : kPK + 8;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;

  const int k_tiles = (K + kPK - 1) / kPK;
  const int total = NK * k_tiles;  // the K loop NK times over
  issue_slice<A_KO>(smem[0][0], a, M, K, m0, 0);
  issue_slice<B_KO>(smem[0][1], b, N, K, n0, 0);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    if (it + 1 < total) {
      const int k0 = ((it + 1) % k_tiles) * kPK;
      issue_slice<A_KO>(smem[st ^ 1][0], a, M, K, m0, k0);
      issue_slice<B_KO>(smem[st ^ 1][1], b, N, K, n0, k0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* sa = smem[st][0];
    const __nv_bfloat16* sb = smem[st][1];
#pragma unroll
    for (int kk = 0; kk < kPK; kk += 16) {
      uint32_t af[2][4], bf[2][2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        load_a<A_KO>(af[mt], sa + slice_at<A_KO>(wm + mt * 16, kk), lda, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        load_b2<B_KO>(bf[np], sb + slice_at<B_KO>(wn + np * 16, kk), ldb, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][nt & 1][0], bf[nt >> 1][nt & 1][1]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm + mt * 16 + g + 8 * r;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + nt * 8 + tq * 2;  // N % 8 == 0: n and n + 1 in or out together
        if (n < N)
          *reinterpret_cast<float2*>(out + (long long)m * N + n) =
              make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
      }
    }
}

template <bool A_KO, bool B_KO>
int launch_probe(const void* a, const void* b, float* out, int BH, int M, int N, int K, int NK,
                 cudaStream_t st) {
  const dim3 grid(((M + kPM - 1) / kPM) * ((N + kPN - 1) / kPN), BH);
  matmul_probe<A_KO, B_KO><<<grid, kPThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), out, M, N, K,
      NK);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- transposed attention

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per K/V tile
constexpr int kF32Rows = 128;     // f32 kernel: query rows per block, one a thread
constexpr int kF32BK = 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Tiling {
  static constexpr int LD = DP + 8;                  // +16 B a row: conflict-free ldmatrix
  static constexpr int kStage = 2 * kBK * LD;        // one K tile + one V tile
  static constexpr int kSmemBytes = 2 * kStage * 2;  // two stages of bf16
  static constexpr int LDO = kBQ + 8;                // the staged [DP][kBQ] output
  static_assert(DP * LDO <= 2 * kStage, "the output tile fits in the two stages");
};

struct Params {
  const void* qkv;  // [B, 3, H, T, D] contiguous
  void* out;        // [B, H, D, T] contiguous
  int H, T, D;
  float scale;
};

// plane j (q 0, k 1, v 2) of head h of batch b: [T, D] rows
template <typename E>
__device__ __forceinline__ const E* plane(const Params& p, int b, int j, int h) {
  return static_cast<const E*>(p.qkv) + (((long long)b * 3 + j) * p.H + h) * p.T * p.D;
}

// keys [k0, k0 + rows) of the K and V planes into one stage (rows >= T and
// columns >= D zero-filled; D % 8 == 0, so a 16-byte chunk is all in or out)
template <int DP>
__device__ __forceinline__ void issue_kv(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                         const __nv_bfloat16* kp, const __nv_bfloat16* vp,
                                         int k0, int T, int D, int rows = kBK) {
  constexpr int LD = Tiling<DP>::LD, kChunks = DP / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, d = (i % kChunks) * 8;
    const bool in = k0 + r < T && d < D;
    const long long off = in ? (long long)(k0 + r) * D + d : 0;
    cp_async16(sK + r * LD + d, kp + off, in);
    cp_async16(sV + r * LD + d, vp + off, in);
  }
}

// k * s rounded to bf16, in place, for the chunks this thread copied
template <int DP>
__device__ __forceinline__ void scale_k(__nv_bfloat16* sK, __nv_bfloat162 s2, int rows = kBK) {
  constexpr int LD = Tiling<DP>::LD, kChunks = DP / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    uint4* ptr = reinterpret_cast<uint4*>(sK + (i / kChunks) * LD + (i % kChunks) * 8);
    uint4 v = *ptr;  // one 16-byte load and store a chunk
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = __hmul2(e[k], s2);
    *ptr = v;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) attn_t_bf16(Params p) {
  using Tl = Tiling<DP>;
  constexpr int LD = Tl::LD, KS = DP / 16, NT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* kp = plane<__nv_bfloat16>(p, b, 1, h);
  const __nv_bfloat16* vp = plane<__nv_bfloat16>(p, b, 2, h);
  const __nv_bfloat162 s2 = __float2bfloat162_rn(p.scale);
  const int n_tiles = (p.T + kBK - 1) / kBK;

  // K/V tile 0 -> stage 0 in flight while q * s is staged through stage 1
  issue_kv<DP>(smem, smem + kBK * LD, kp, vp, 0, p.T, p.D);
  cp_async_commit();
  {
    __nv_bfloat16* sQ = smem + Tl::kStage;
    const __nv_bfloat16* qp = plane<__nv_bfloat16>(p, b, 0, h);
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < kBQ * kChunks; i += kThreads) {
      const int r = i / kChunks, d = (i % kChunks) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < p.T && d < p.D) {
        v = *reinterpret_cast<const uint4*>(qp + (long long)(q0 + r) * p.D + d);
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] = __hmul2(e[k], s2);
      }
      *reinterpret_cast<uint4*>(sQ + r * LD + d) = v;
    }
  }
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    load_a<false>(qa[kk], smem + Tl::kStage + (warp * 16) * LD + kk * 16, LD, lane);
  __syncthreads();  // stage 1 is free for K/V tile 1

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8

  for (int kt = 0; kt < n_tiles; ++kt) {
    __nv_bfloat16* sK = smem + (kt & 1) * Tl::kStage;
    const __nv_bfloat16* sV = sK + kBK * LD;
    if (kt + 1 < n_tiles) {
      __nv_bfloat16* nK = smem + ((kt + 1) & 1) * Tl::kStage;
      issue_kv<DP>(nK, nK + kBK * LD, kp, vp, (kt + 1) * kBK, p.T, p.D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    scale_k<DP>(sK, s2);
    __syncthreads();

    // S = (q s)(k s)^T: 16 rows x 64 keys a warp
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bf[2][2];
        load_b2<false>(bf, sK + (np * 16) * LD + kk * 16, LD, lane);
        mma_bf16(s[2 * np], qa[kk], bf[0][0], bf[0][1]);
        mma_bf16(s[2 * np + 1], qa[kk], bf[1][0], bf[1][1]);
      }
    const int k0 = kt * kBK;
    if (k0 + kBK > p.T) {  // ragged tail: keys past T never win
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + tq * 2 + (e & 1) >= p.T) s[n][e] = -INFINITY;
    }

    // online softmax in f32, base 2; the 4 threads of a group share a row
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float alpha = ex2((m[r] - mn) * kLog2e);  // 0 on the first tile
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
      const float mb = mn * kLog2e;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        s[n][2 * r] = ex2(fmaf(s[n][2 * r], kLog2e, -mb));
        s[n][2 * r + 1] = ex2(fmaf(s[n][2 * r + 1], kLog2e, -mb));
        rs += s[n][2 * r] + s[n][2 * r + 1];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] += rs;
    }
    // two n8 score tiles make one k16 A fragment of P (p rounded to bf16)
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    }

    // O += P V: V stored [key][d] is the k-outer B operand
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[2][2];
        load_b2<true>(bf, sV + (j * 16) * LD + np * 16, LD, lane);
        mma_bf16(o[2 * np], pa[j], bf[0][0], bf[0][1]);
        mma_bf16(o[2 * np + 1], pa[j], bf[1][0], bf[1][1]);
      }
    __syncthreads();  // stage kt & 1 is refilled with tile kt + 2 next
  }

  // epilogue: normalise, stage [DP][kBQ] transposed, write D rows of tokens
  __nv_bfloat16* sO = smem;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + tq * 2;
      sO[d * Tl::LDO + row] = __float2bfloat16(o[n][2 * r] * inv);
      sO[(d + 1) * Tl::LDO + row] = __float2bfloat16(o[n][2 * r + 1] * inv);
    }
  }
  __syncthreads();
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + (long long)bh * p.D * p.T;
  for (int i = threadIdx.x; i < p.D * kBQ; i += kThreads) {
    const int d = i / kBQ, r = i % kBQ;
    if (q0 + r < p.T) out[(long long)d * p.T + q0 + r] = sO[d * Tl::LDO + r];
  }
}

template <int DP>
__global__ void __launch_bounds__(kF32Rows) attn_t_f32(Params p) {
  __shared__ __align__(16) float sK[kF32BK][DP];
  __shared__ __align__(16) float sV[kF32BK][DP];

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int row = blockIdx.x * kF32Rows + threadIdx.x;
  const float* qp = plane<float>(p, b, 0, h);
  const float* kp = plane<float>(p, b, 1, h);
  const float* vp = plane<float>(p, b, 2, h);

  float q[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    q[d] = (row < p.T && d < p.D) ? qp[(long long)row * p.D + d] * p.scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int n_tiles = (p.T + kF32BK - 1) / kF32BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32BK;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BK * (DP / 4); i += kF32Rows) {
      const int r = i / (DP / 4), d = (i % (DP / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < p.T && d < p.D) {
        kv = *reinterpret_cast<const float4*>(kp + (long long)(k0 + r) * p.D + d);
        vv = *reinterpret_cast<const float4*>(vp + (long long)(k0 + r) * p.D + d);
        kv.x *= p.scale;
        kv.y *= p.scale;
        kv.z *= p.scale;
        kv.w *= p.scale;
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

  if (row < p.T) {  // consecutive threads, consecutive tokens of each d row
    float* out = static_cast<float*>(p.out) + (long long)bh * p.D * p.T + row;
    const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < p.D) out[(long long)d * p.T] = acc[d] * inv;
  }
}

template <int DP>
int launch_attn(const Params& p, int bh, int is_f32, cudaStream_t st) {
  if (is_f32) {
    const dim3 grid((p.T + kF32Rows - 1) / kF32Rows, bh);
    attn_t_f32<DP><<<grid, kF32Rows, 0, st>>>(p);
  } else {
    constexpr int smem = Tiling<DP>::kSmemBytes;
    if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
      const cudaError_t err = cudaFuncSetAttribute(
          attn_t_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((p.T + kBQ - 1) / kBQ, bh);
    attn_t_bf16<DP><<<grid, kThreads, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- hybrid attention

constexpr int kSub = 64;  // keys of one register score tile

template <int DP>
struct HTiling {
  static constexpr int LD = DP + 8;
  static constexpr int MT = DP <= 64 ? 2 : 1;  // m16 query tiles a warp (K1's choice)
  static constexpr int BQ = 16 * MT * kWarps;  // query rows a block
  static constexpr int LDP = kSub + 8;         // a warp's p tile [16 MT][kSub] (hybrid)
  static constexpr int kPWarp = 16 * MT * LDP;
  // two stages of bk K rows and bk V rows, then (hybrid) the warps' p tiles
  static int smem_bytes(int bk, bool p_smem) {
    return 2 * (2 * 2 * bk * LD + (p_smem ? kWarps * kPWarp : 0));
  }
};

// P_SMEM: p goes through shared memory (kern_hybrid, p transposed explicitly);
// else p passes from the QK^T accumulators to the PV^T B operand in registers
// (kern_hybrid2, p contracted on its dim 1)
template <int DP, bool P_SMEM, int BK>
__global__ void __launch_bounds__(kThreads) attn_hybrid(Params p) {
  using Tl = HTiling<DP>;
  constexpr int LD = Tl::LD, MT = Tl::MT, KS = DP / 16, DT = DP / 16;
  constexpr int stage = 2 * BK * LD;  // one K tile + one V tile, elements
  static_assert(Tl::BQ <= 2 * BK, "q is staged through one K/V stage");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * Tl::BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  __nv_bfloat16* sP = smem + 2 * stage + warp * Tl::kPWarp;
  const __nv_bfloat16* kp = plane<__nv_bfloat16>(p, b, 1, h);
  const __nv_bfloat16* vp = plane<__nv_bfloat16>(p, b, 2, h);
  const __nv_bfloat162 s2 = __float2bfloat162_rn(p.scale);
  const int n_tiles = (p.T + BK - 1) / BK;

  // K/V tile 0 -> stage 0 in flight while q * s is staged through stage 1
  issue_kv<DP>(smem, smem + BK * LD, kp, vp, 0, p.T, p.D, BK);
  cp_async_commit();
  {
    __nv_bfloat16* sQ = smem + stage;
    const __nv_bfloat16* qp = plane<__nv_bfloat16>(p, b, 0, h);
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < Tl::BQ * kChunks; i += kThreads) {
      const int r = i / kChunks, d = (i % kChunks) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < p.T && d < p.D) {
        v = *reinterpret_cast<const uint4*>(qp + (long long)(q0 + r) * p.D + d);
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] = __hmul2(e[k], s2);
      }
      *reinterpret_cast<uint4*>(sQ + r * LD + d) = v;
    }
  }
  __syncthreads();
  uint32_t qa[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      load_a<false>(qa[mt][kk], smem + stage + ((warp * MT + mt) * 16) * LD + kk * 16, LD, lane);
  __syncthreads();  // stage 1 is free for K/V tile 1

  // acc^T [d][query]: m16 tile dt of d x n8 tile of queries (2 mt + r: rows
  // 8r..8r+7 of query tile mt). Thread (g, tq) holds d = 16 dt + g (+8) and
  // queries 2 tq, 2 tq + 1 of its n8 tile.
  float acc[DT][2 * MT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int n = 0; n < 2 * MT; ++n) acc[dt][n][0] = acc[dt][n][1] = acc[dt][n][2] =
        acc[dt][n][3] = 0.f;
  float m[MT][2], l[MT][2];  // this thread's query rows g and g + 8 of each tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = -INFINITY, l[mt][0] = l[mt][1] = 0.f;
  // lanes holding the statistics of queries 2 tq and 2 tq + 1 of an n8 tile
  const int src0 = (2 * tq) * 4, src1 = (2 * tq + 1) * 4;

  for (int kt = 0; kt < n_tiles; ++kt) {
    __nv_bfloat16* sK = smem + (kt & 1) * stage;
    const __nv_bfloat16* sV = sK + BK * LD;
    if (kt + 1 < n_tiles) {
      __nv_bfloat16* nK = smem + ((kt + 1) & 1) * stage;
      issue_kv<DP>(nK, nK + BK * LD, kp, vp, (kt + 1) * BK, p.T, p.D, BK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    scale_k<DP>(sK, s2, BK);
    __syncthreads();

#pragma unroll
    for (int c = 0; c < BK; c += kSub) {
      const int k0 = kt * BK + c;
      if (k0 >= p.T) break;  // the same for every warp
      // S = (q s)(k s)^T: MT x 16 rows x 64 keys a warp; each K fragment
      // (two plain 32-bit loads, as K1 reads it) feeds MT products
      float s[MT][kSub / 8][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] =
            s[mt][n][3] = 0.f;
        const __nv_bfloat16* kr = sK + (c + n * 8 + g) * LD + tq * 2;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(s[mt][n], qa[mt][kk], b0, b1);
        }
      }
      if (k0 + kSub > p.T) {  // ragged tail: keys past T never win
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + n * 8 + tq * 2 + (e & 1) >= p.T) s[mt][n][e] = -INFINITY;
      }

      // online softmax over the rows (f32, base 2), as K1; then each alpha
      // moves from the lanes of its query row to the lanes of its acc^T column
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < kSub / 8; ++n)
            mx = fmaxf(mx, fmaxf(s[mt][n][2 * r], s[mt][n][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(m[mt][r], mx);
          alpha[r] = ex2((m[mt][r] - mn) * kLog2e);  // 0 on the first tile
          m[mt][r] = mn;
          const float mb = mn * kLog2e;
          float rs = 0.f;
#pragma unroll
          for (int n = 0; n < kSub / 8; ++n) {
            s[mt][n][2 * r] = ex2(fmaf(s[mt][n][2 * r], kLog2e, -mb));
            s[mt][n][2 * r + 1] = ex2(fmaf(s[mt][n][2 * r + 1], kLog2e, -mb));
            rs += s[mt][n][2 * r] + s[mt][n][2 * r + 1];
          }
          rs += __shfl_xor_sync(0xffffffffu, rs, 1);
          rs += __shfl_xor_sync(0xffffffffu, rs, 2);
          l[mt][r] = l[mt][r] * alpha[r] + rs;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float a0 = __shfl_sync(0xffffffffu, alpha[r], src0);
          const float a1 = __shfl_sync(0xffffffffu, alpha[r], src1);
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            acc[dt][2 * mt + r][0] *= a0;
            acc[dt][2 * mt + r][1] *= a1;
            acc[dt][2 * mt + r][2] *= a0;
            acc[dt][2 * mt + r][3] *= a1;
          }
        }
      }

      // the B operands of acc^T += V^T P^T (k16 x n8: 16 keys x 8 queries),
      // p rounded to bf16: pb[mt][r][j] for keys 16 j.. of queries 8 r.. of mt
      uint32_t pb[MT][2][kSub / 16][2];
      if (P_SMEM) {
        // p [query][key] into the warp's tile, read back through ldmatrix
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<uint32_t*>(sP + (mt * 16 + g + 8 * r) * Tl::LDP + n * 8 +
                                           tq * 2) =
                  pack_bf16(s[mt][n][2 * r], s[mt][n][2 * r + 1]);
        __syncwarp();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < kSub / 16; ++j) {
            uint32_t bf[2][2];
            load_b2<false>(bf, sP + (mt * 16) * Tl::LDP + j * 16, Tl::LDP, lane);
#pragma unroll
            for (int r = 0; r < 2; ++r) pb[mt][r][j][0] = bf[r][0], pb[mt][r][j][1] = bf[r][1];
          }
        __syncwarp();  // every lane has read the tile before it is rewritten
      } else {
        // the m16n8 score fragment of (query g (+8), keys 2 tq, 2 tq + 1) is
        // the k16 x n8 B fragment of P^T: no shuffle
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < kSub / 16; ++j) {
              pb[mt][r][j][0] = pack_bf16(s[mt][2 * j][2 * r], s[mt][2 * j][2 * r + 1]);
              pb[mt][r][j][1] = pack_bf16(s[mt][2 * j + 1][2 * r], s[mt][2 * j + 1][2 * r + 1]);
            }
      }

      // acc^T += V^T P^T: V stored [key][d] is the k-outer A operand
      // (ldmatrix.trans); each V fragment feeds 2 MT products
#pragma unroll
      for (int j = 0; j < kSub / 16; ++j)
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          uint32_t va[4];
          load_a<true>(va, sV + (c + j * 16) * LD + dt * 16, LD, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              mma_bf16(acc[dt][2 * mt + r], va, pb[mt][r][j][0], pb[mt][r][j][1]);
        }
    }
    __syncthreads();  // stage kt & 1 is refilled with tile kt + 2 next
  }

  // epilogue: acc^T / l straight into o [B, H, D, T], two tokens a store
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + (long long)bh * p.D * p.T;
  const bool pairs = (p.T & 1) == 0;  // then every pair is 4-byte aligned
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = l[mt][r] == 0.f ? 0.f : 1.f / l[mt][r];
      const float i0 = __shfl_sync(0xffffffffu, inv, src0);
      const float i1 = __shfl_sync(0xffffffffu, inv, src1);
      const int t = q0 + (warp * MT + mt) * 16 + 8 * r + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int hd = 0; hd < 2; ++hd) {
          const int d = dt * 16 + g + 8 * hd;
          if (d >= p.D) continue;
          const float v0 = acc[dt][2 * mt + r][2 * hd] * i0;
          const float v1 = acc[dt][2 * mt + r][2 * hd + 1] * i1;
          __nv_bfloat16* o = out + (long long)d * p.T + t;
          if (pairs && t + 1 < p.T) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (t < p.T) o[0] = __float2bfloat16(v0);
            if (t + 1 < p.T) o[1] = __float2bfloat16(v1);
          }
        }
    }
}

template <int DP, int BK>
int launch_hybrid_bk(const Params& p, int bh, int p_smem, cudaStream_t st) {
  const int smem = HTiling<DP>::smem_bytes(BK, p_smem != 0);
  const dim3 grid((p.T + HTiling<DP>::BQ - 1) / HTiling<DP>::BQ, bh);
  const auto kernel = p_smem ? attn_hybrid<DP, true, BK> : attn_hybrid<DP, false, BK>;
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 64 keys a stage at every head dim; 128 and 256 (the probe's stage sweep)
// for D <= 64
template <int DP>
int launch_hybrid(const Params& p, int bh, int p_smem, int bk, cudaStream_t st) {
  if (bk == kSub) return launch_hybrid_bk<DP, kSub>(p, bh, p_smem, st);
  if constexpr (DP <= 64) {
    if (bk == 2 * kSub) return launch_hybrid_bk<DP, 2 * kSub>(p, bh, p_smem, st);
    if (bk == 4 * kSub) return launch_hybrid_bk<DP, 4 * kSub>(p, bh, p_smem, st);
  }
  return -1;
}

}  // namespace

// a, b bf16 [BH, ...] contiguous with 16-byte-aligned bases, out f32 [BH, M, N];
// layout 0 NT (a [M, K], b [N, K]), 1 NN (a [M, K], b [K, N]), 2 TN (a [K,
// M], b [K, N]). M, N and K multiples of 8. Returns 0, a CUDA error code, or
// -1 for an argument it does not take.
extern "C" int eo_matmul_probe(const void* a, const void* b, float* out, int layout, int BH,
                               int M, int N, int K, int NK, int device, void* stream) {
  if (BH < 1 || BH > 65535 || M < 8 || N < 8 || K < 8 || M % 8 || N % 8 || K % 8 || NK < 1)
    return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case 0: return launch_probe<false, false>(a, b, out, BH, M, N, K, NK, st);
    case 1: return launch_probe<false, true>(a, b, out, BH, M, N, K, NK, st);
    case 2: return launch_probe<true, true>(a, b, out, BH, M, N, K, NK, st);
    default: return -1;
  }
}

// qkv5 [B, 3, H, T, D] contiguous (bf16 with is_f32 0, else f32; 16-byte-aligned
// base), out [B, H, D, T] in the same dtype; scale = D^-1/4 rounded to that
// dtype. Any T >= 1; D a multiple of 8 up to 128. Returns 0, a CUDA error
// code, or -1 for an argument it does not take.
extern "C" int eo_attention_fwd_transposed(const void* qkv5, void* out, int is_f32, int B,
                                           int H, int T, int D, float scale, int device,
                                           void* stream) {
  if (B < 1 || H < 1 || T < 1 || D < 8 || D > 128 || D % 8 || (long long)B * H > 65535)
    return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.qkv = qkv5;
  p.out = out;
  p.H = H;
  p.T = T;
  p.D = D;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_attn<16>(p, B * H, is_f32, st);
    case 32: return launch_attn<32>(p, B * H, is_f32, st);
    case 48: return launch_attn<48>(p, B * H, is_f32, st);
    case 64: return launch_attn<64>(p, B * H, is_f32, st);
    case 80: return launch_attn<80>(p, B * H, is_f32, st);
    case 96: return launch_attn<96>(p, B * H, is_f32, st);
    case 112: return launch_attn<112>(p, B * H, is_f32, st);
    case 128: return launch_attn<128>(p, B * H, is_f32, st);
    default: return -1;
  }
}

// The hybrid attention: qkv5 [B, 3, H, T, D] bf16 contiguous (16-byte-aligned
// base) -> out [B, H, D, T] bf16, with PV computed transposed. p_smem 1 hands
// p from QK^T to PV through shared memory, 0 in registers; bk keys a K/V
// stage: 64, or for D <= 64 also 128 or 256. scale = D^-1/4 rounded to
// bf16. Any T >= 1; D a multiple of 8 up to 128. Returns 0, a CUDA error
// code, or -1 for an argument it does not take.
extern "C" int eo_attention_hybrid(const void* qkv5, void* out, int p_smem, int B, int H, int T,
                                   int D, int bk, float scale, int device, void* stream) {
  if (B < 1 || H < 1 || T < 1 || D < 8 || D > 128 || D % 8 || (long long)B * H > 65535 ||
      bk < kSub)
    return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.qkv = qkv5;
  p.out = out;
  p.H = H;
  p.T = T;
  p.D = D;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_hybrid<16>(p, B * H, p_smem, bk, st);
    case 32: return launch_hybrid<32>(p, B * H, p_smem, bk, st);
    case 48: return launch_hybrid<48>(p, B * H, p_smem, bk, st);
    case 64: return launch_hybrid<64>(p, B * H, p_smem, bk, st);
    case 80: return launch_hybrid<80>(p, B * H, p_smem, bk, st);
    case 96: return launch_hybrid<96>(p, B * H, p_smem, bk, st);
    case 112: return launch_hybrid<112>(p, B * H, p_smem, bk, st);
    case 128: return launch_hybrid<128>(p, B * H, p_smem, bk, st);
    default: return -1;
  }
}
