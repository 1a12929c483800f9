// GroupNorm + per-sample affine (FiLM) + optional SiLU for Hopper (sm_90a),
// forward and backward, bound through ctypes.
//
// Replaces the TPU kernel `_gn_kernel` (eo_diffusion_tpu/ops/group_norm.py:48,
// launched by `_gn_pallas` at :77) and, for the backward, the XLA recompute
// of `_gn_bwd` (:104). It computes the same function, not the same blocks:
//
//   y[n, p, c] = act((x[n, p, c] - mean[n, g]) * rstd[n, g] * gamma[n, c] + beta[n, c])
//
// over a channels-last x [N, HW, C] in bf16 or f32, with g = c / (C / G),
// statistics over all HW * C/G values of (n, g) in f32, rstd = 1/sqrt(var +
// eps), act = identity or SiLU, the arithmetic in f32 and one rounding of
// the output. gamma and beta are f32 [N, C]: a FiLM scale-shift folds into
// them (gamma = w * (1 + scale), beta = b * (1 + scale) + shift).
//
// What bounds it on the H100: a few f32 operations per element against 2
// (bf16) or 4 (f32) bytes each way, far below the card's ridge, so bytes.
// The least it can move is x read once and y written once (forward) and x,
// dy read once and dx written once (backward); at the clouds UNet's level 0
// (N 8, HW 65536, C 128, bf16) one tensor is 134 MB, so 0.080 ms forward and
// 0.120 ms backward at 3.35 TB/s.
//
// The TPU kernel holds one sample's whole [HW, C] slab in VMEM and gets the
// group sums from a [C, G] indicator matmul. That does not carry over: the
// level-0 slab is 16 MiB (shared memory holds 227 KB), a grid of N blocks
// would fill 8 of 132 SMs, and a reshape of the channel axis gives the
// groups for free. The design here:
//   * every kernel runs over a grid of (HW chunk, sample) blocks; a thread
//     owns VEC consecutive channels (16-byte loads along C) and walks the
//     chunk's rows with a stride of `rows_per_iter`, so a warp reads whole
//     contiguous rows and any group width (C/G = 1 ... 64, also 12, 20, 28)
//     is handled per channel;
//   * forward, three kernels: `gn_stats` writes per-(chunk, group) partials
//     (mean, M2); `gn_finalize` combines a sample's partials per group with
//     Chan's formula into mean and rstd [N, G] (kept for the backward);
//     `gn_apply` reads x a second time and writes y. Sums of squares are
//     taken about a shift (each channel's first value in the chunk), and
//     chunks and channels combine as (count, mean, M2): E[x^2] - E[x]^2 in
//     f32 over 262144 values would cancel when |mean| >> std;
//   * backward, three kernels: `gn_bwd_reduce` recomputes x_hat and the SiLU
//     derivative from x, the saved mean and rstd, gamma and beta, and writes
//     per-chunk partial sums of dy_p and dy_p * x_hat per channel;
//     `gn_bwd_finalize` sums them in a fixed order into dbeta and dgamma
//     [N, C] (no atomics: the same bits every run); `gn_dx` forms the two
//     group sums of gamma*dbeta and gamma*dgamma in shared memory and writes
//     dx = rstd * (gamma*dy_p - sum(gamma*dbeta)/M - x_hat * sum(gamma*dgamma)/M);
//   * each of the two passes reads x (and dy) twice; the second read of a
//     chunk follows soon after the first, and one sample's level-0 slab
//     (16 MiB) fits in the 50 MB L2, which a later version can exploit.
//
// Scratch (the partials) is allocated by the caller; the kernels allocate
// nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads a block aims for
constexpr int kMaxThreads = 512;  // a block at most (128 registers a thread)
constexpr int kMaxSmemBytes = 48 * 1024;

struct Layout {
  int N, HW, C, G, cg;  // cg = C / G channels a group
  int vecs;             // C / VEC vectors a row
  int rows_per_iter;    // rows a block covers at once (threads / vecs)
  int chunk_rows;       // rows a block owns (a multiple of rows_per_iter)
  int chunks;           // blocks a sample
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC values moved as one load or store of 2 to 16 bytes
template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

template <typename T, int VEC>
struct Vec {
  using Raw = typename RawOf<sizeof(T) * VEC>::type;
  Raw raw;
  __device__ __forceinline__ T& operator[](int i) { return reinterpret_cast<T*>(&raw)[i]; }
  __device__ __forceinline__ T operator[](int i) const {
    return reinterpret_cast<const T*>(&raw)[i];
  }
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  Vec<T, VEC> v;
  v.raw = *reinterpret_cast<const typename Vec<T, VEC>::Raw*>(p);
  return v;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Vec<T, VEC>& v) {
  *reinterpret_cast<typename Vec<T, VEC>::Raw*>(p) = v.raw;
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// Chan's parallel combine of (count, mean, M2) partials
__device__ __forceinline__ void chan(float& n, float& m, float& m2, float nb, float mb,
                                     float m2b) {
  if (nb == 0.f) return;
  const float nab = n + nb;
  const float delta = mb - m;
  const float w = nb / nab;
  m += delta * w;
  m2 += m2b + delta * delta * n * w;
  n = nab;
}

// One block: rows [r0, r1) of sample n. Thread layout: col = tid % vecs owns
// channels [col*VEC, col*VEC + VEC), slot = tid / vecs starts at row r0 + slot.
struct Tile {
  int n, col, slot, r0, r1;
  __device__ Tile(const Layout& L) {
    n = blockIdx.y;
    col = threadIdx.x % L.vecs;
    slot = threadIdx.x / L.vecs;
    r0 = blockIdx.x * L.chunk_rows;
    r1 = min(r0 + L.chunk_rows, L.HW);
  }
};

// Sum the per-thread channel sums a[VEC], b[VEC] over the block's row slots:
// on return sm[c] and sm[C + c] hold the block's totals for channel c.
// Uses (2 * rows_per_iter + 2) * C floats of sm.
template <int VEC>
__device__ __forceinline__ void block_channel_sums(const Layout& L, const Tile& t,
                                                   const float* a, const float* b,
                                                   float* sm) {
  const int C = L.C;
  float* pa = sm + 2 * C;
  float* pb = pa + L.rows_per_iter * C;
  if (t.slot < L.rows_per_iter) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      pa[t.slot * C + t.col * VEC + i] = a[i];
      pb[t.slot * C + t.col * VEC + i] = b[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sa = 0.f, sb = 0.f;
    for (int s = 0; s < L.rows_per_iter; ++s) {  // fixed order
      sa += pa[s * C + c];
      sb += pb[s * C + c];
    }
    sm[c] = sa;
    sm[C + c] = sb;
  }
  __syncthreads();
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads) gn_stats(const T* __restrict__ x,
                                                        float2* __restrict__ part, Layout L) {
  extern __shared__ float sm[];
  const Tile t(L);
  const T* xs = x + (long long)t.n * L.HW * L.C + t.col * VEC;
  // shift: the channel's first value in the chunk
  const Vec<T, VEC> k = load<T, VEC>(xs + (long long)t.r0 * L.C);
  float shift[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    shift[i] = to_f(k[i]);
    s1[i] = s2[i] = 0.f;
  }
  if (t.slot < L.rows_per_iter) {
#pragma unroll 4
    for (int r = t.r0 + t.slot; r < t.r1; r += L.rows_per_iter) {
      const Vec<T, VEC> v = load<T, VEC>(xs + (long long)r * L.C);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = to_f(v[i]) - shift[i];
        s1[i] += d;
        s2[i] = fmaf(d, d, s2[i]);
      }
    }
  }
  // the per-channel shifts, for the combine below
  float* shifts = sm + 2 * L.C + 2 * L.rows_per_iter * L.C;
  if (t.slot == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) shifts[t.col * VEC + i] = shift[i];
  }
  block_channel_sums<VEC>(L, t, s1, s2, sm);
  // channel c: count rows, mean shift + S1/rows, M2 = S2 - S1^2/rows; a
  // group's channels have equal counts, so mean_g is their average and
  // M2_g = sum M2_c + rows * sum (mean_c - mean_g)^2
  const float rows = (float)(t.r1 - t.r0);
  for (int g = threadIdx.x; g < L.G; g += blockDim.x) {
    float msum = 0.f;
    for (int j = 0; j < L.cg; ++j) {
      const int c = g * L.cg + j;
      msum += shifts[c] + sm[c] / rows;
    }
    const float mg = msum / (float)L.cg;
    float m2 = 0.f, dev = 0.f;
    for (int j = 0; j < L.cg; ++j) {
      const int c = g * L.cg + j;
      const float s = sm[c];
      const float dm = shifts[c] + s / rows - mg;
      m2 += sm[L.C + c] - s * s / rows;
      dev = fmaf(dm, dm, dev);
    }
    part[((long long)t.n * L.chunks + blockIdx.x) * L.G + g] =
        make_float2(mg, fmaxf(m2, 0.f) + rows * dev);
  }
}

// One block a sample, one warp a group at a time: lanes combine chunks
// k = lane, lane + 32, ...; a butterfly over the lanes (fixed order) joins them.
__global__ void gn_finalize(const float2* __restrict__ part, float* __restrict__ mean,
                            float* __restrict__ rstd, Layout L, float eps) {
  const int n = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int g = warp; g < L.G; g += blockDim.x / 32) {
    float cnt = 0.f, m = 0.f, m2 = 0.f;
    for (int k = lane; k < L.chunks; k += 32) {
      const float2 p = part[((long long)n * L.chunks + k) * L.G + g];
      const int rows = min(L.chunk_rows, L.HW - k * L.chunk_rows);
      chan(cnt, m, m2, (float)rows * (float)L.cg, p.x, p.y);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_xor_sync(0xffffffffu, cnt, off);
      const float mb = __shfl_xor_sync(0xffffffffu, m, off);
      const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
      // both lanes of a pair combine in the same order (lower lane first)
      if (lane & off) {
        float n0 = nb, mm = mb, mm2 = m2b;
        chan(n0, mm, mm2, cnt, m, m2);
        cnt = n0, m = mm, m2 = mm2;
      } else {
        chan(cnt, m, m2, nb, mb, m2b);
      }
    }
    if (lane == 0) {
      mean[n * L.G + g] = m;
      rstd[n * L.G + g] = rsqrtf(m2 / cnt + eps);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    gn_apply(const T* __restrict__ x, const float* __restrict__ gamma,
             const float* __restrict__ beta, const float* __restrict__ mean,
             const float* __restrict__ rstd, T* __restrict__ y, Layout L, int act_silu) {
  const Tile t(L);
  if (t.slot >= L.rows_per_iter) return;
  float mu[VEC], a[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = t.col * VEC + i;
    const int g = t.n * L.G + c / L.cg;
    mu[i] = mean[g];
    a[i] = rstd[g] * gamma[t.n * L.C + c];
    b[i] = beta[t.n * L.C + c];
  }
  const long long base = (long long)t.n * L.HW * L.C + t.col * VEC;
#pragma unroll 4
  for (int r = t.r0 + t.slot; r < t.r1; r += L.rows_per_iter) {
    const long long off = base + (long long)r * L.C;
    const Vec<T, VEC> v = load<T, VEC>(x + off);
    Vec<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float h = fmaf(to_f(v[i]) - mu[i], a[i], b[i]);
      if (act_silu) h = silu(h);
      o[i] = from_f<T>(h);
    }
    store<T, VEC>(y + off, o);
  }
}

// The per-channel constants of the backward: mean, rstd, gamma, beta.
template <int VEC>
struct ChannelConsts {
  float mu[VEC], r[VEC], ga[VEC], be[VEC];
  __device__ ChannelConsts(const Layout& L, const Tile& t, const float* gamma,
                           const float* beta, const float* mean, const float* rstd) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = t.col * VEC + i;
      const int g = t.n * L.G + c / L.cg;
      mu[i] = mean[g];
      r[i] = rstd[g];
      ga[i] = gamma[t.n * L.C + c];
      be[i] = beta[t.n * L.C + c];
    }
  }
  // x_hat, and dy taken back through the SiLU (dy_p)
  __device__ __forceinline__ void eval(int i, float xv, float dyv, int act_silu, float& xh,
                                       float& dyp) const {
    xh = (xv - mu[i]) * r[i];
    dyp = dyv;
    if (act_silu) {
      const float yp = fmaf(xh, ga[i], be[i]);
      const float s = 1.f / (1.f + expf(-yp));
      dyp = dyv * s * fmaf(yp, 1.f - s, 1.f);
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  float* __restrict__ part, Layout L, int act_silu) {
  extern __shared__ float sm[];
  const Tile t(L);
  float db[VEC], dg[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) db[i] = dg[i] = 0.f;
  if (t.slot < L.rows_per_iter) {
    const ChannelConsts<VEC> k(L, t, gamma, beta, mean, rstd);
    const long long base = (long long)t.n * L.HW * L.C + t.col * VEC;
#pragma unroll 4
    for (int r = t.r0 + t.slot; r < t.r1; r += L.rows_per_iter) {
      const long long off = base + (long long)r * L.C;
      const Vec<T, VEC> xv = load<T, VEC>(x + off);
      const Vec<T, VEC> gv = load<T, VEC>(dy + off);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float xh, dyp;
        k.eval(i, to_f(xv[i]), to_f(gv[i]), act_silu, xh, dyp);
        db[i] += dyp;
        dg[i] = fmaf(dyp, xh, dg[i]);
      }
    }
  }
  block_channel_sums<VEC>(L, t, db, dg, sm);
  float* out = part + ((long long)t.n * L.chunks + blockIdx.x) * 2 * L.C;
  for (int c = threadIdx.x; c < L.C; c += blockDim.x) {
    out[c] = sm[c];
    out[L.C + c] = sm[L.C + c];
  }
}

// dbeta[n, c] and dgamma[n, c]: the chunks' partials summed in chunk order.
// Grid (ceil(C / 32), N), block (32, 8): threadIdx.y strides over chunks.
__global__ void gn_bwd_finalize(const float* __restrict__ part, float* __restrict__ dgamma,
                                float* __restrict__ dbeta, Layout L) {
  __shared__ float sb[8][33], sg[8][33];
  const int n = blockIdx.y, c = blockIdx.x * 32 + threadIdx.x;
  float b = 0.f, g = 0.f;
  if (c < L.C) {
    for (int k = threadIdx.y; k < L.chunks; k += 8) {
      const float* p = part + ((long long)n * L.chunks + k) * 2 * L.C;
      b += p[c];
      g += p[L.C + c];
    }
  }
  sb[threadIdx.y][threadIdx.x] = b;
  sg[threadIdx.y][threadIdx.x] = g;
  __syncthreads();
  if (threadIdx.y == 0 && c < L.C) {
    for (int s = 1; s < 8; ++s) {
      b += sb[s][threadIdx.x];
      g += sg[s][threadIdx.x];
    }
    dbeta[n * L.C + c] = b;
    dgamma[n * L.C + c] = g;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    gn_dx(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ gamma,
          const float* __restrict__ beta, const float* __restrict__ mean,
          const float* __restrict__ rstd, const float* __restrict__ dgamma,
          const float* __restrict__ dbeta, T* __restrict__ dx, Layout L, int act_silu) {
  extern __shared__ float sm[];  // [G] sum(gamma*dbeta)/M, then [G] sum(gamma*dgamma)/M
  const Tile t(L);
  const float inv_m = 1.f / ((float)L.HW * (float)L.cg);
  for (int g = threadIdx.x; g < L.G; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < L.cg; ++j) {
      const int c = t.n * L.C + g * L.cg + j;
      s1 = fmaf(gamma[c], dbeta[c], s1);
      s2 = fmaf(gamma[c], dgamma[c], s2);
    }
    sm[g] = s1 * inv_m;
    sm[L.G + g] = s2 * inv_m;
  }
  __syncthreads();
  if (t.slot >= L.rows_per_iter) return;
  const ChannelConsts<VEC> k(L, t, gamma, beta, mean, rstd);
  float c1[VEC], c2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int g = (t.col * VEC + i) / L.cg;
    c1[i] = sm[g];
    c2[i] = sm[L.G + g];
  }
  const long long base = (long long)t.n * L.HW * L.C + t.col * VEC;
#pragma unroll 4
  for (int r = t.r0 + t.slot; r < t.r1; r += L.rows_per_iter) {
    const long long off = base + (long long)r * L.C;
    const Vec<T, VEC> xv = load<T, VEC>(x + off);
    const Vec<T, VEC> gv = load<T, VEC>(dy + off);
    Vec<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float xh, dyp;
      k.eval(i, to_f(xv[i]), to_f(gv[i]), act_silu, xh, dyp);
      o[i] = from_f<T>(k.r[i] * (k.ga[i] * dyp - c1[i] - xh * c2[i]));
    }
    store<T, VEC>(dx + off, o);
  }
}

// The widest vector (16 bytes at most) that divides C and every pointer.
int pick_vec(int esize, int C, const void* const* ptrs, int nptrs) {
  for (int vec = 16 / esize; vec > 1; vec /= 2) {
    bool ok = C % vec == 0;
    for (int i = 0; i < nptrs; ++i)
      ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % (uintptr_t)(vec * esize) == 0;
    if (ok) return vec;
  }
  return 1;
}

// Fills L for `chunks_max` blocks a sample at most; 0, or -1 for a shape the
// kernels do not take.
int plan(Layout& L, int N, int HW, int C, int G, int vec, int chunks_max) {
  if (N < 1 || N > 65535 || HW < 1 || C < 1 || G < 1 || C % G != 0 || chunks_max < 1)
    return -1;
  L.N = N, L.HW = HW, L.C = C, L.G = G, L.cg = C / G;
  L.vecs = C / vec;
  if (L.vecs > kMaxThreads) return -1;
  L.rows_per_iter = L.vecs >= kThreads ? 1 : kThreads / L.vecs;
  const int want = (HW + chunks_max - 1) / chunks_max;
  L.chunk_rows = (want + L.rows_per_iter - 1) / L.rows_per_iter * L.rows_per_iter;
  L.chunks = (HW + L.chunk_rows - 1) / L.chunk_rows;
  if (L.chunks > 65535) return -1;
  const size_t smem = (size_t)(2 * L.rows_per_iter + 3) * C * sizeof(float);
  if (smem > (size_t)kMaxSmemBytes || 2 * (size_t)G * sizeof(float) > (size_t)kMaxSmemBytes)
    return -1;
  return 0;
}

int threads(const Layout& L) { return L.vecs * L.rows_per_iter; }
size_t stats_smem(const Layout& L) {
  return (size_t)(2 * L.rows_per_iter + 3) * L.C * sizeof(float);
}

template <typename T, int VEC>
int fwd(const Layout& L, const void* x, const float* gamma, const float* beta, void* y,
        float* mean, float* rstd, float* work, float eps, int act_silu, cudaStream_t st) {
  const dim3 grid(L.chunks, L.N);
  float2* part = reinterpret_cast<float2*>(work);
  gn_stats<T, VEC><<<grid, threads(L), stats_smem(L), st>>>(static_cast<const T*>(x), part, L);
  gn_finalize<<<L.N, kThreads, 0, st>>>(part, mean, rstd, L, eps);
  gn_apply<T, VEC><<<grid, threads(L), 0, st>>>(static_cast<const T*>(x), gamma, beta, mean,
                                                rstd, static_cast<T*>(y), L, act_silu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int bwd(const Layout& L, const void* x, const void* dy, const float* gamma, const float* beta,
        const float* mean, const float* rstd, void* dx, float* dgamma, float* dbeta,
        float* work, int act_silu, cudaStream_t st) {
  const dim3 grid(L.chunks, L.N);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  gn_bwd_reduce<T, VEC><<<grid, threads(L), stats_smem(L), st>>>(xt, dyt, gamma, beta, mean,
                                                                 rstd, work, L, act_silu);
  gn_bwd_finalize<<<dim3((L.C + 31) / 32, L.N), dim3(32, 8), 0, st>>>(work, dgamma, dbeta, L);
  gn_dx<T, VEC><<<grid, threads(L), 2 * L.G * sizeof(float), st>>>(
      xt, dyt, gamma, beta, mean, rstd, dgamma, dbeta, static_cast<T*>(dx), L, act_silu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward. x, y: [N, HW, C] contiguous, bf16 (is_f32 = 0) or f32; gamma, beta:
// [N, C] f32; mean, rstd: [N, G] f32 outputs; work: at least
// 2 * N * chunks_max * G floats of scratch. Returns cudaGetLastError() after
// the launches (0 on success), or -1 for a shape the kernels do not take.
extern "C" int eo_group_norm_fwd(const void* x, const float* gamma, const float* beta, void* y,
                                 float* mean, float* rstd, float* work, int is_f32, int N,
                                 int HW, int C, int G, float eps, int act_silu, int chunks_max,
                                 int device, void* stream) {
  const void* ptrs[2] = {x, y};
  const int esize = is_f32 ? 4 : 2;
  const int vec = pick_vec(esize, C, ptrs, 2);
  Layout L;
  if (plan(L, N, HW, C, G, vec, chunks_max) != 0) return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    switch (vec) {
      case 4: return fwd<float, 4>(L, x, gamma, beta, y, mean, rstd, work, eps, act_silu, st);
      case 2: return fwd<float, 2>(L, x, gamma, beta, y, mean, rstd, work, eps, act_silu, st);
      default: return fwd<float, 1>(L, x, gamma, beta, y, mean, rstd, work, eps, act_silu, st);
    }
  }
  using bf = __nv_bfloat16;
  switch (vec) {
    case 8: return fwd<bf, 8>(L, x, gamma, beta, y, mean, rstd, work, eps, act_silu, st);
    case 4: return fwd<bf, 4>(L, x, gamma, beta, y, mean, rstd, work, eps, act_silu, st);
    case 2: return fwd<bf, 2>(L, x, gamma, beta, y, mean, rstd, work, eps, act_silu, st);
    default: return fwd<bf, 1>(L, x, gamma, beta, y, mean, rstd, work, eps, act_silu, st);
  }
}

// Backward. x, dy, dx: [N, HW, C] contiguous in one dtype; gamma, beta: [N, C]
// f32; mean, rstd: [N, G] f32 from the forward; dgamma, dbeta: [N, C] f32
// outputs; work: at least 2 * N * chunks_max * C floats of scratch.
extern "C" int eo_group_norm_bwd(const void* x, const void* dy, const float* gamma,
                                 const float* beta, const float* mean, const float* rstd,
                                 void* dx, float* dgamma, float* dbeta, float* work, int is_f32,
                                 int N, int HW, int C, int G, int act_silu, int chunks_max,
                                 int device, void* stream) {
  const void* ptrs[3] = {x, dy, dx};
  const int esize = is_f32 ? 4 : 2;
  const int vec = pick_vec(esize, C, ptrs, 3);
  Layout L;
  if (plan(L, N, HW, C, G, vec, chunks_max) != 0) return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EO_GN_BWD(T, V) \
  bwd<T, V>(L, x, dy, gamma, beta, mean, rstd, dx, dgamma, dbeta, work, act_silu, st)
  if (is_f32) {
    switch (vec) {
      case 4: return EO_GN_BWD(float, 4);
      case 2: return EO_GN_BWD(float, 2);
      default: return EO_GN_BWD(float, 1);
    }
  }
  switch (vec) {
    case 8: return EO_GN_BWD(__nv_bfloat16, 8);
    case 4: return EO_GN_BWD(__nv_bfloat16, 4);
    case 2: return EO_GN_BWD(__nv_bfloat16, 2);
    default: return EO_GN_BWD(__nv_bfloat16, 1);
  }
#undef EO_GN_BWD
}
