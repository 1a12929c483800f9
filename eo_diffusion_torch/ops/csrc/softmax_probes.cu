// The softmax-orientation probes for Hopper (sm_90a), bound through ctypes: two
// memory-bound kernels with a plain C interface.
//
// 1. eo_softmax_stats replaces `_cellwise` with `bench_reduce`'s body
//    (tools/probe_softmax_orient.py:52, body :64, call :53): per cell of
//    [BH], r = max + sum(exp(s - max)) along one axis of s [M, N] f32, summed
//    NK times (acc = r, then acc + r), f32 out. axis 1 reduces each row (the
//    TPU's lane reduction, out [BH, M, 1]); axis 0 each column (its sublane
//    reduction, out [BH, 1, N]).
//    Bound on the H100: one f32 read of s, at the probe's [64, 512, 2048]
//    268.4 MB, 0.0801 ms at 3.35 TB/s (bytes); about one exp an element is
//    far below the SFU rate. The TPU grid ran the same cell NQ = 8 times
//    (every q tile rewrote the same output block); here each cell is
//    computed once.
//    Design: the statistics stream in one pass with an online (max, sum)
//    pair a thread, merged across threads at the end; each batch of four
//    loaded values costs one exp for the rescale and four for the sum.
//    Rows: one warp a row, 16-byte loads when N % 4 == 0, scalar ones
//    otherwise; consecutive lanes read consecutive addresses. Columns
//    (Hopper's form of the lane/sublane question): a block of 8 warps owns
//    32 columns, lane = column, so every warp load is one 128-byte line of a
//    row; the 8 warps walk interleaved rows, four rows in flight a thread,
//    and merge their pairs through shared memory.
//
// 2. eo_transpose_accumulate replaces `bench_transpose`'s body
//    (tools/probe_softmax_orient.py:90, call :97): out [BH, N, M] f32 =
//    p^T summed NK times in p's dtype (bf16: acc = p^T, then acc + p^T, so
//    2 p^T exactly for NK 2), then widened to f32.
//    Bound on the H100: 134.2 MB of bf16 read plus 268.4 MB of f32 written
//    at the probe's shape, 0.1202 ms (bytes).
//    Design: 32 x 64 tiles of p through shared memory, stored transposed
//    with rows padded to 33 (no bank conflict on the read-out); a block of 8
//    warps reads rows of p as bf16 pairs (128 bytes a warp load) and writes
//    rows of out with consecutive lanes on consecutive m (128 bytes a warp
//    store). Ragged M and N are masked; an odd N reads single elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kColWarps = 8;    // warps of a column block
constexpr int kRowsInFlight = 4;
constexpr int kRowWarps = 8;    // rows (one a warp) of a row block
constexpr int kTileM = 32;      // transpose tile: rows of p
constexpr int kTileN = 64;      // and its columns (rows of out)
constexpr int kTileRows = 8;    // warps of a transpose block

// (m, l) <- the pair of the union, l in units of exp(-m); an empty side has
// m = -inf and l = 0
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
  m = mn;
}

// fold K values into this thread's (m, l)
template <int K>
__device__ __forceinline__ void absorb(float& m, float& l, const float (&x)[K]) {
  float mx = x[0];
#pragma unroll
  for (int i = 1; i < K; ++i) mx = fmaxf(mx, x[i]);
  const float mn = fmaxf(m, mx);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) s += expf(x[i] - mn);
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + s;
  m = mn;
}

__device__ __forceinline__ float finish(float m, float l, int NK) {
  const float r = m + l;
  float acc = r;
  for (int k = 1; k < NK; ++k) acc = acc + r;
  return acc;
}

template <bool VEC>
__global__ void __launch_bounds__(32 * kRowWarps) stats_rows(const float* __restrict__ s,
                                                            float* __restrict__ out,
                                                            long long rows, int N, int NK) {
  const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* src = s + row * N;
  float m = -INFINITY, l = 0.f;
  if (VEC) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int n4 = N / 4;
    for (int i = lane; i < n4; i += 32) {
      const float4 v = src4[i];
      const float x[4] = {v.x, v.y, v.z, v.w};
      absorb<4>(m, l, x);
    }
  } else {
    for (int i = lane; i < N; i += 32) {
      const float x[1] = {src[i]};
      absorb<1>(m, l, x);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, m2, l2);
  }
  if (lane == 0) out[row] = finish(m, l, NK);
}

__global__ void __launch_bounds__(32 * kColWarps) stats_cols(const float* __restrict__ s,
                                                            float* __restrict__ out, int M,
                                                            int N, int NK) {
  __shared__ float sm[kColWarps][32], sl[kColWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const long long cell = blockIdx.y;
  const float* src = s + cell * M * N + col;
  float m = -INFINITY, l = 0.f;
  if (col < N) {
    int r = warp;
    for (; r + (kRowsInFlight - 1) * kColWarps < M; r += kRowsInFlight * kColWarps) {
      float x[kRowsInFlight];
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) x[i] = src[(long long)(r + i * kColWarps) * N];
      absorb<kRowsInFlight>(m, l, x);
    }
    for (; r < M; r += kColWarps) {
      const float x[1] = {src[(long long)r * N]};
      absorb<1>(m, l, x);
    }
  }
  sm[warp][lane] = m;
  sl[warp][lane] = l;
  __syncthreads();
  if (warp == 0 && col < N) {
    for (int w = 1; w < kColWarps; ++w) merge(m, l, sm[w][lane], sl[w][lane]);
    out[cell * N + col] = finish(m, l, NK);
  }
}

__global__ void __launch_bounds__(32 * kTileRows) transpose_acc(
    const __nv_bfloat16* __restrict__ p, float* __restrict__ out, int M, int N, int NK) {
  __shared__ float tile[kTileN][kTileM + 1];  // [n][m]
  const long long cell = blockIdx.z;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const bool pairs = (N & 1) == 0;  // then every even column starts a 4-byte pair
  p += cell * M * N;
  out += cell * M * N;
  // read: lane tx takes columns 2 tx, 2 tx + 1 of a row (128 bytes a warp)
#pragma unroll
  for (int i = ty; i < kTileM; i += kTileRows) {
    const int m = m0 + i, n = n0 + 2 * tx;
    if (m >= M || n >= N) continue;
    const __nv_bfloat16* src = p + (long long)m * N + n;
    if (pairs) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(src);
      __nv_bfloat162 acc = v;
      for (int k = 1; k < NK; ++k) acc = __hadd2(acc, v);  // the sum in p's dtype
      tile[2 * tx][i] = __low2float(acc);
      tile[2 * tx + 1][i] = __high2float(acc);
    } else {
      for (int j = 0; j < 2 && n + j < N; ++j) {
        const __nv_bfloat16 v = src[j];
        __nv_bfloat16 acc = v;
        for (int k = 1; k < NK; ++k) acc = __hadd(acc, v);
        tile[2 * tx + j][i] = __bfloat162float(acc);
      }
    }
  }
  __syncthreads();
  // write: lane tx takes row m0 + tx of an output row (128 bytes a warp)
#pragma unroll
  for (int i = ty; i < kTileN; i += kTileRows) {
    const int n = n0 + i, m = m0 + tx;
    if (n < N && m < M) out[(long long)n * M + m] = tile[i][tx];
  }
}

}  // namespace

// s f32 [BH, M, N] contiguous; axis 1: out [BH, M] (one value a row), axis 0:
// out [BH, N] (one a column). Returns 0, a CUDA error code, or -1 for an
// argument it does not take.
extern "C" int eo_softmax_stats(const float* s, float* out, int axis, int BH, int M, int N,
                                int NK, int device, void* stream) {
  if (BH < 1 || M < 1 || N < 1 || NK < 1 || (axis != 0 && axis != 1)) return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (axis == 1) {
    const long long rows = (long long)BH * M;
    const long long blocks = (rows + kRowWarps - 1) / kRowWarps;
    if (blocks > 2147483647LL) return -1;
    const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
    if (vec)
      stats_rows<true><<<(unsigned)blocks, 32 * kRowWarps, 0, st>>>(s, out, rows, N, NK);
    else
      stats_rows<false><<<(unsigned)blocks, 32 * kRowWarps, 0, st>>>(s, out, rows, N, NK);
  } else {
    if (BH > 65535) return -1;
    stats_cols<<<dim3((N + 31) / 32, BH), 32 * kColWarps, 0, st>>>(s, out, M, N, NK);
  }
  return static_cast<int>(cudaGetLastError());
}

// p bf16 [BH, M, N] contiguous, out f32 [BH, N, M]. Returns 0, a CUDA error
// code, or -1 for an argument it does not take.
extern "C" int eo_transpose_accumulate(const void* p, float* out, int BH, int M, int N, int NK,
                                       int device, void* stream) {
  if (BH < 1 || BH > 65535 || M < 1 || N < 1 || NK < 1 || (M + kTileM - 1) / kTileM > 65535)
    return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, BH);
  transpose_acc<<<grid, 32 * kTileRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(p), out, M, N, NK);
  return static_cast<int>(cudaGetLastError());
}
