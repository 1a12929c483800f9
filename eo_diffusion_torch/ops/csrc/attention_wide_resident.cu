// The first wide-head attention pair (the score row block resident in
// shared memory), forward and backward, bound through ctypes. No model path
// launches it: attention_wide.cu replaced it, and chip_smoke.py times it
// beside that body on the same tensors as its yardstick.
//
// It takes head dims above the attention bodies' limits (256 in bf16, 128 in
// float32) at T up to kMaxT, and computes the plain version's function
// (ops/attention.py, reference_attention / reference_attention_bwd), step
// for step, as attention_wide.cu states it.
//
// Design. A CTA keeps the whole row block of scores in shared memory
// instead of streaming keys with an online softmax, and sweeps D in chunks:
//   * forward: one CTA of 256 threads per (batch*head, 16 query rows).
//     Scores: key tiles of 64, D in chunks of 32 through shared memory
//     (each thread owns 4 of the 16 x 64 tile's scores); softmax: a warp a
//     row; PV: D in chunks of 64 (each thread owns 4 of the 16 x 64 output
//     tile), keys in tiles of 64 through shared memory.
//   * backward, two kernels: the first per (batch*head, 16 query rows)
//     computes S and dP in one sweep of D, p and ds in place, writes them
//     (rounded, so exactly) to a [B*H, T, T] scratch in the input dtype, and
//     dq from ds and k; the second per (batch*head, 16 keys) reads p and ds
//     back by columns and computes dv and dk. No atomics.
// All products run on the FMA units in float32. The grid is
// ceil(T/16) x B*H: 32 CTAs for 132 SMs at B8 T64 H1.
//
// Shared memory: the forward holds 16 x T float scores (64 KiB at T 1024)
// beside 27 KiB of tiles; the first backward kernel twice that for p and
// ds. Both ask for it above the 48 KiB default.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // query rows (keys in the second backward kernel) a CTA
constexpr int kKeys = 64;  // keys (queries) of a tile
constexpr int kDc = 32;    // head-dim chunk of a score product
constexpr int kDo = 64;    // head-dim chunk of an output product
constexpr int kMaxT = 1024;

// element (b, t, h, d) of a plane sits at ptr + b*sb + t*st + h*sh + d
struct Plane {
  const void* ptr;
  long long sb, st, sh;
};

template <typename T>
__device__ __forceinline__ float ld(const T* p, long long i);
template <>
__device__ __forceinline__ float ld<float>(const float* p, long long i) {
  return p[i];
}
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__device__ __forceinline__ T to(float x);
template <>
__device__ __forceinline__ float to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as PyTorch rounds
}

// x rounded to the input dtype and read back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  const T y = to<T>(x);
  return ld<T>(&y, 0);
}

template <typename T>
__device__ __forceinline__ const T* head(const Plane& p, int b, int h) {
  return static_cast<const T*>(p.ptr) + b * p.sb + h * p.sh;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows x kDc tile of plane rows [i0, i0 + rows), dims [d0, d0 + kDc), times
// scale and rounded to the input dtype when `scaled`; zero outside T and D
template <typename T, int kTileRows, bool kScaled>
__device__ __forceinline__ void load_chunk(float (*dst)[kDc + 1], const T* base, long long st,
                                           int i0, int d0, int Tn, int D, float s_in) {
  for (int e = threadIdx.x; e < kTileRows * kDc; e += kThreads) {
    const int r = e / kDc, c = e % kDc, i = i0 + r, d = d0 + c;
    float x = 0.f;
    if (i < Tn && d < D) {
      x = ld<T>(base, i * st + d);
      if (kScaled) x = rnd<T>(x * s_in);
    }
    dst[r][c] = x;
  }
}

// the same for a kKeys x kDo tile
template <typename T, bool kScaled>
__device__ __forceinline__ void load_wide(float (*dst)[kDo + 1], const T* base, long long st,
                                          int i0, int d0, int Tn, int D, float s_in) {
  for (int e = threadIdx.x; e < kKeys * kDo; e += kThreads) {
    const int r = e / kDo, c = e % kDo, i = i0 + r, d = d0 + c;
    float x = 0.f;
    if (i < Tn && d < D) {
      x = ld<T>(base, i * st + d);
      if (kScaled) x = rnd<T>(x * s_in);
    }
    dst[r][c] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wide_fwd(Plane q, Plane k, Plane v, T* __restrict__ out, float* __restrict__ lse, int Tn,
             int H, int D, int Tp, float s_in) {
  extern __shared__ float scores[];  // [kRows][Tp]: scores, then probabilities
  __shared__ float qt[kRows][kDc + 1];
  __shared__ float kt[kKeys][kDc + 1];
  __shared__ float vt[kKeys][kDo + 1];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, i0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const T *qb = head<T>(q, b, h), *kb = head<T>(k, b, h), *vb = head<T>(v, b, h);

  for (int j0 = 0; j0 < Tp; j0 += kKeys) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += kDc) {
      load_chunk<T, kRows, true>(qt, qb, q.st, i0, d0, Tn, D, s_in);
      load_chunk<T, kKeys, true>(kt, kb, k.st, j0, d0, Tn, D, s_in);
      __syncthreads();
#pragma unroll 8
      for (int x = 0; x < kDc; ++x) {
        const float a = qt[r][x];
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[m] = fmaf(a, kt[c + 16 * m][x], acc[m]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) scores[r * Tp + j0 + c + 16 * m] = acc[m];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    float* s = scores + rr * Tp;
    float mx = -INFINITY;
    for (int j = lane; j < Tn; j += 32) mx = fmaxf(mx, s[j]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float e = expf(s[j] - mx);
      s[j] = e;
      l += e;
    }
    l = warp_sum(l);
    const float inv = 1.f / l;
    for (int j = lane; j < Tp; j += 32) s[j] = j < Tn ? s[j] * inv : 0.f;
    if (lse != nullptr && lane == 0 && i0 + rr < Tn)
      lse[(long long)bh * Tn + i0 + rr] = mx + logf(l);
  }
  __syncthreads();

  const int i = i0 + r;
  for (int d0 = 0; d0 < D; d0 += kDo) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < Tn; j0 += kKeys) {
      load_wide<T, false>(vt, vb, v.st, j0, d0, Tn, D, 0.f);
      __syncthreads();
      const float* p = scores + r * Tp + j0;
#pragma unroll 8
      for (int x = 0; x < kKeys; ++x) {
        const float w = p[x];
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[m] = fmaf(w, vt[x][c + 16 * m], acc[m]);
      }
      __syncthreads();
    }
    if (i < Tn) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int d = d0 + c + 16 * m;
        if (d < D) out[(((long long)b * Tn + i) * H + h) * D + d] = to<T>(acc[m]);
      }
    }
  }
}

// backward, first kernel: p, ds and dq of 16 query rows
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wide_bwd_rows(Plane q, Plane k, Plane v, const T* __restrict__ out,
                  const T* __restrict__ dout, const float* __restrict__ lse, T* __restrict__ dq,
                  T* __restrict__ pbuf, T* __restrict__ dsbuf, int Tn, int H, int D, int Tp,
                  float s_in, float sc) {
  extern __shared__ float smem[];  // p [kRows][Tp], then ds [kRows][Tp]
  float* ps = smem;
  float* dss = smem + kRows * Tp;
  __shared__ float qt[kRows][kDc + 1];
  __shared__ float gt[kRows][kDc + 1];
  __shared__ float kt[kKeys][kDc + 1];
  __shared__ float vt[kKeys][kDc + 1];
  __shared__ float kw[kKeys][kDo + 1];
  __shared__ float delta[kRows];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, i0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const T *qb = head<T>(q, b, h), *kb = head<T>(k, b, h), *vb = head<T>(v, b, h);
  // o and do are [B, T, H, D] contiguous
  const long long ost = (long long)H * D;
  const T* ob = out + ((long long)b * Tn * H + h) * D;
  const T* gb = dout + ((long long)b * Tn * H + h) * D;

  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const int i = i0 + rr;
    float acc = 0.f;
    if (i < Tn)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(ld<T>(gb, i * ost + d), ld<T>(ob, i * ost + d), acc);
    acc = warp_sum(acc);
    if (lane == 0) delta[rr] = acc;
  }

  for (int j0 = 0; j0 < Tp; j0 += kKeys) {
    float as[4] = {0.f, 0.f, 0.f, 0.f}, ap[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += kDc) {
      load_chunk<T, kRows, true>(qt, qb, q.st, i0, d0, Tn, D, s_in);
      load_chunk<T, kRows, false>(gt, gb, ost, i0, d0, Tn, D, 0.f);
      load_chunk<T, kKeys, true>(kt, kb, k.st, j0, d0, Tn, D, s_in);
      load_chunk<T, kKeys, false>(vt, vb, v.st, j0, d0, Tn, D, 0.f);
      __syncthreads();
#pragma unroll 8
      for (int x = 0; x < kDc; ++x) {
        const float a = qt[r][x], g = gt[r][x];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          as[m] = fmaf(a, kt[c + 16 * m][x], as[m]);
          ap[m] = fmaf(g, vt[c + 16 * m][x], ap[m]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      ps[r * Tp + j0 + c + 16 * m] = as[m];
      dss[r * Tp + j0 + c + 16 * m] = ap[m];
    }
  }
  __syncthreads();

  for (int e = tid; e < kRows * Tp; e += kThreads) {
    const int rr = e / Tp, j = e % Tp, i = i0 + rr;
    float p = 0.f, ds = 0.f;
    if (i < Tn && j < Tn) {
      p = expf(ps[e] - lse[(long long)bh * Tn + i]);
      ds = rnd<T>(p * (dss[e] - delta[rr]));
      p = rnd<T>(p);
      const long long at = ((long long)bh * Tn + i) * Tn + j;
      pbuf[at] = to<T>(p);
      dsbuf[at] = to<T>(ds);
    }
    ps[e] = p;
    dss[e] = ds;
  }
  __syncthreads();

  const int i = i0 + r;
  for (int d0 = 0; d0 < D; d0 += kDo) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < Tn; j0 += kKeys) {
      load_wide<T, true>(kw, kb, k.st, j0, d0, Tn, D, s_in);
      __syncthreads();
      const float* w = dss + r * Tp + j0;
#pragma unroll 8
      for (int x = 0; x < kKeys; ++x) {
        const float a = w[x];
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[m] = fmaf(a, kw[x][c + 16 * m], acc[m]);
      }
      __syncthreads();
    }
    if (i < Tn) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int d = d0 + c + 16 * m;
        if (d < D) dq[(((long long)b * Tn + i) * H + h) * D + d] = to<T>(acc[m] * sc);
      }
    }
  }
}

// backward, second kernel: dv and dk of 16 keys from p and ds by columns
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wide_bwd_keys(Plane q, const T* __restrict__ dout, const T* __restrict__ pbuf,
                  const T* __restrict__ dsbuf, T* __restrict__ dk, T* __restrict__ dv, int Tn,
                  int H, int D, float s_in, float sc) {
  __shared__ float pt[kKeys][kRows + 1];  // [query][key]
  __shared__ float dst[kKeys][kRows + 1];
  __shared__ float gw[kKeys][kDo + 1];
  __shared__ float qw[kKeys][kDo + 1];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, j0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const T* qb = head<T>(q, b, h);
  const long long ost = (long long)H * D;
  const T* gb = dout + ((long long)b * Tn * H + h) * D;
  const T* pb = pbuf + (long long)bh * Tn * Tn;
  const T* db = dsbuf + (long long)bh * Tn * Tn;

  const int j = j0 + r;
  for (int d0 = 0; d0 < D; d0 += kDo) {
    float av[4] = {0.f, 0.f, 0.f, 0.f}, ak[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = 0; i0 < Tn; i0 += kKeys) {
      for (int e = tid; e < kKeys * kRows; e += kThreads) {
        const int ii = e / kRows, kk = e % kRows, i = i0 + ii, jj = j0 + kk;
        const bool in = i < Tn && jj < Tn;
        pt[ii][kk] = in ? ld<T>(pb, (long long)i * Tn + jj) : 0.f;
        dst[ii][kk] = in ? ld<T>(db, (long long)i * Tn + jj) : 0.f;
      }
      load_wide<T, false>(gw, gb, ost, i0, d0, Tn, D, 0.f);
      load_wide<T, true>(qw, qb, q.st, i0, d0, Tn, D, s_in);
      __syncthreads();
#pragma unroll 8
      for (int x = 0; x < kKeys; ++x) {
        const float pw = pt[x][r], dw = dst[x][r];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          av[m] = fmaf(pw, gw[x][c + 16 * m], av[m]);
          ak[m] = fmaf(dw, qw[x][c + 16 * m], ak[m]);
        }
      }
      __syncthreads();
    }
    if (j < Tn) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int d = d0 + c + 16 * m;
        if (d < D) {
          const long long at = (((long long)b * Tn + j) * H + h) * D + d;
          dv[at] = to<T>(av[m]);
          dk[at] = to<T>(ak[m] * sc);
        }
      }
    }
  }
}

int check(int B, int T, int H, int D, int device) {
  if (B < 1 || H < 1 || T < 1 || T > kMaxT || D < 8 || D % 8 || (long long)B * H > 65535)
    return -1;
  const cudaError_t set = cudaSetDevice(device);
  return set == cudaSuccess ? 0 : static_cast<int>(set);
}

void planes(const void* q, const void* k, const void* v, const long long* strides,
            Plane* out) {
  const void* ptrs[3] = {q, k, v};
  for (int j = 0; j < 3; ++j) out[j] = {ptrs[j], strides[3 * j], strides[3 * j + 1],
                                        strides[3 * j + 2]};
}

template <typename T>
int fwd(const Plane* p, void* out, float* lse, int B, int Tn, int H, int D, float s_in,
        cudaStream_t st) {
  const int Tp = (Tn + kKeys - 1) / kKeys * kKeys;
  const size_t dyn = sizeof(float) * kRows * Tp;
  cudaError_t e = cudaFuncSetAttribute(wide_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(dyn));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Tn + kRows - 1) / kRows, B * H);
  wide_fwd<T><<<grid, kThreads, dyn, st>>>(p[0], p[1], p[2], static_cast<T*>(out), lse, Tn, H,
                                           D, Tp, s_in);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const Plane* p, const void* out, const void* dout, const float* lse, void* dq,
        void* dk, void* dv, void* pbuf, void* dsbuf, int B, int Tn, int H, int D, float s_in,
        float sc, cudaStream_t st) {
  const int Tp = (Tn + kKeys - 1) / kKeys * kKeys;
  const size_t dyn = 2 * sizeof(float) * kRows * Tp;
  cudaError_t e = cudaFuncSetAttribute(
      wide_bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Tn + kRows - 1) / kRows, B * H);
  wide_bwd_rows<T><<<grid, kThreads, dyn, st>>>(
      p[0], p[1], p[2], static_cast<const T*>(out), static_cast<const T*>(dout), lse,
      static_cast<T*>(dq), static_cast<T*>(pbuf), static_cast<T*>(dsbuf), Tn, H, D, Tp, s_in,
      sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wide_bwd_keys<T><<<grid, kThreads, 0, st>>>(
      p[0], static_cast<const T*>(dout), static_cast<const T*>(pbuf),
      static_cast<const T*>(dsbuf), static_cast<T*>(dk), static_cast<T*>(dv), Tn, H, D, s_in,
      sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries return cudaGetLastError() after the launches (0 on success),
// or -1 for an argument the kernels do not take (T above kMaxT, D not a
// multiple of 8, B*H beyond the grid). Pointers are device pointers; q, k
// and v are three [B, T, H, D] tensors or views, strides holding their
// (batch, token, head) strides in elements, q's three first, each with unit
// stride along D. s_in is D^-1/4 rounded to the input dtype, sc the same in
// float32.

// out [B, T, H, D] contiguous; lse, when not null, [B*H, T] float32
extern "C" int eo_attention_wide_resident_fwd(const void* q, const void* k, const void* v,
                                              const long long* strides, void* out, float* lse,
                                              int is_f32, int B, int T, int H, int D,
                                              float s_in, int device, void* stream) {
  const int rc = check(B, T, H, D, device);
  if (rc != 0) return rc;
  Plane p[3];
  planes(q, k, v, strides, p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? fwd<float>(p, out, lse, B, T, H, D, s_in, st)
                : fwd<__nv_bfloat16>(p, out, lse, B, T, H, D, s_in, st);
}

// out, dout, dq, dk, dv [B, T, H, D] contiguous; lse [B*H, T] float32 from
// the forward; pbuf and dsbuf [B*H, T, T] scratch in the input dtype
extern "C" int eo_attention_wide_resident_bwd(const void* q, const void* k, const void* v,
                                              const long long* strides, const void* out,
                                              const void* dout, const float* lse, void* dq,
                                              void* dk, void* dv, void* pbuf, void* dsbuf,
                                              int is_f32, int B, int T, int H, int D,
                                              float s_in, float sc, int device,
                                              void* stream) {
  const int rc = check(B, T, H, D, device);
  if (rc != 0) return rc;
  Plane p[3];
  planes(q, k, v, strides, p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? bwd<float>(p, out, dout, lse, dq, dk, dv, pbuf, dsbuf, B, T, H, D, s_in, sc,
                             st)
                : bwd<__nv_bfloat16>(p, out, dout, lse, dq, dk, dv, pbuf, dsbuf, B, T, H, D,
                                     s_in, sc, st);
}
