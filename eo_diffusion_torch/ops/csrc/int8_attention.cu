// W8A8 attention core for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel `_int8_kernel` (tools/probe_int8_attn.py:82,
// launched by `core_int8_pallas` at :118). For each [T, D] cell of q, k, v
// [B*H, T, D] (bf16 or f32) it computes the same function:
//
//   s_x  = max|x| / 127 + 1e-12 (f32), for q, k and v, over the whole cell
//   x_i  = round(x / s_x) to int8 (round half to even)
//   S    = q_i k_i^T in int32;  sf = S * (s_q * s_k * scale)   (scale = D^-1/2)
//   p    = exp(sf - max_row sf);  l = sum_row p                 (f32)
//   p_i  = round(p * 127) to int8
//   o    = (p_i v_i in int32) * (s_v / 127) / l, in the input dtype
//
// What bounds it on the H100: at the probe's shape (B*H 384, T 256, D 64,
// bf16) the kernel must read q, k, v and write o, 4 * 384 * 256 * 64 * 2 B =
// 50.3 MB, 15.0 us at 3.35 TB/s, against 4 * 384 * 256^2 * 64 = 6.4 G int8
// operations, 3.3 us at 1,979 TOPS: bytes.
//
// The design, one block of 8 warps a cell:
//   * amax first: every thread reads its share of the cell (4 elements at a
//     time) and the block reduces the three maxima; the cell is then read a
//     second time (from L2) and quantised into shared memory: q and k as
//     int8 rows of D + 16 bytes (the pad spreads a warp's 32-bit fragment
//     loads over all 32 banks), v transposed, [D][T + 16], with the keys of
//     each 32-key chunk permuted (below). 3 * T * D bytes plus pads: 57 KB
//     at T 256, D 64, so three blocks fit an SM;
//   * each warp owns 16 query rows at a time. Pass 1 runs S = q_i k_i^T with
//     `mma.sync.m16n8k32.s8` over all keys and keeps only the int32 row max
//     (the f32 max of sf is float(max S) * scale exactly: the scale is
//     positive and rounding is monotone). Pass 2 recomputes S 32 keys at a
//     time, forms p, l and p_i in registers and multiplies p_i by v_i with a
//     second int8 `mma.sync`, accumulating o in int32. Recomputing S costs
//     one more QK^T (1.6 G operations), far below the byte bound; the row of
//     256 scores never leaves registers;
//   * p_i goes from the accumulator layout of the QK^T product (a thread
//     holds keys 2t, 2t+1 of each 8-key tile) straight into the A operand of
//     the PV product (a thread holds k-indices 4t..4t+3 and 16+4t..) with no
//     shuffle: a contraction may take its k-indices in any order, so v's
//     keys are stored in the matching order, k-index 4t + r <- key 2t + r
//     (r < 2) or 8 + 2t + r - 2 (r >= 2), and the same +16 for the second
//     half of the chunk;
//   * the products are exact in int32 (|S| <= 127^2 * 64, |p_i v_i| <=
//     127^2 * 256) and every f32 step rounds where the plain version rounds
//     (no fused multiply-add), so kernel and plain version differ only where
//     exp's last bit moves round(p * 127) by one step, and in the order of
//     l's sum.
//
// T must be a multiple of 32 up to 256 and D 32 or 64 (the probe's T 256, D
// 64 and smaller test shapes); the entry point returns -1 on anything else.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxT = 256;
constexpr int kPad = 16;  // bytes after each int8 row in shared memory

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 a = p2[0], b = p2[1];
  o[0] = __low2float(a);
  o[1] = __high2float(a);
  o[2] = __low2float(b);
  o[3] = __high2float(b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ int quant(float x, float s) { return __float2int_rn(x / s); }

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t(a) & 0xffu) | ((uint32_t(b) & 0xffu) << 8) | ((uint32_t(c) & 0xffu) << 16) |
         ((uint32_t(d) & 0xffu) << 24);
}

// d[0..3] += a (16x32 s8, row) * b (32x8 s8, col) in s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the k-index that key j (0..31) of a 32-key chunk takes in v's shared copy
__device__ __forceinline__ int key_slot(int j) {
  const int jj = j & 15;
  return (j & 16) + 4 * ((jj & 7) >> 1) + (jj & 1) + 2 * (jj >> 3);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D>
constexpr int smem_bytes(int T) {
  return 2 * T * (D + kPad) + D * (T + kPad);
}

template <typename TIn, int D>
__global__ void __launch_bounds__(kThreads)
    int8_attn(const TIn* __restrict__ q, const TIn* __restrict__ k, const TIn* __restrict__ v,
              TIn* __restrict__ o, int T, float scale) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int QS = D + kPad;  // q, k row stride in bytes
  const int VS = T + kPad;      // v^T row stride in bytes
  int8_t* qs = smem;
  int8_t* ks = qs + T * QS;
  int8_t* vt = ks + T * QS;
  __shared__ float red[3][kWarps];
  __shared__ float scales[3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = size_t(blockIdx.x) * T * D;
  const TIn* src[3] = {q + base, k + base, v + base};
  const int n4 = T * D / 4;

  // 1. the three amaxes of the cell
  float amax[3] = {0.f, 0.f, 0.f};
  for (int i = tid; i < n4; i += kThreads) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float x[4];
      load4(src[s] + 4 * i, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) amax[s] = fmaxf(amax[s], fabsf(x[e]));
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const float m = warp_max(amax[s]);
    if (lane == 0) red[s][warp] = m;
  }
  __syncthreads();
  if (tid < 3) {
    float m = red[tid][0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[tid][w]);
    scales[tid] = m / 127.0f + 1e-12f;
  }
  __syncthreads();
  const float sq = scales[0], sk = scales[1], sv = scales[2];

  // 2. quantise into shared memory: q, k row-major, v transposed and permuted
  for (int i = tid; i < n4; i += kThreads) {
    const int row = (4 * i) / D, col = (4 * i) % D;
    float x[4];
    load4(src[0] + 4 * i, x);
    *reinterpret_cast<uint32_t*>(qs + row * QS + col) =
        pack4(quant(x[0], sq), quant(x[1], sq), quant(x[2], sq), quant(x[3], sq));
    load4(src[1] + 4 * i, x);
    *reinterpret_cast<uint32_t*>(ks + row * QS + col) =
        pack4(quant(x[0], sk), quant(x[1], sk), quant(x[2], sk), quant(x[3], sk));
    load4(src[2] + 4 * i, x);
    const int slot = (row & ~31) + key_slot(row & 31);
#pragma unroll
    for (int e = 0; e < 4; ++e) vt[(col + e) * VS + slot] = int8_t(quant(x[e], sv));
  }
  __syncthreads();

  // 3. 16 query rows a warp at a time
  const int g = lane >> 2, t = lane & 3;
  const float cscale = sq * sk * scale;
  const float oscale = sv / 127.0f;
  constexpr int KS = D / 32;  // k-steps of QK^T
  constexpr int ND = D / 8;   // n-tiles of PV
  for (int r0 = 16 * warp; r0 < T; r0 += 16 * kWarps) {
    uint32_t aq[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int8_t* qa = qs + (r0 + g) * QS + 32 * s + 4 * t;
      aq[s][0] = ld32(qa);
      aq[s][1] = ld32(qa + 8 * QS);
      aq[s][2] = ld32(qa + 16);
      aq[s][3] = ld32(qa + 8 * QS + 16);
    }
    // pass 1: the int32 row max of S (rows g and g + 8 of the tile)
    int mx[2] = {INT_MIN, INT_MIN};
    for (int n0 = 0; n0 < T; n0 += 8) {
      int c[4] = {0, 0, 0, 0};
      const int8_t* kb = ks + (n0 + g) * QS + 4 * t;
#pragma unroll
      for (int s = 0; s < KS; ++s) mma_s8(c, aq[s], ld32(kb + 32 * s), ld32(kb + 32 * s + 16));
      mx[0] = max(mx[0], max(c[0], c[1]));
      mx[1] = max(mx[1], max(c[2], c[3]));
    }
    float m[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m[h] = __fmul_rn(float(mx[h]), cscale);
    }
    // pass 2: p, l and p_i 32 keys at a time, then p_i v_i
    int acc[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0;
    for (int k0 = 0; k0 < T; k0 += 32) {
      int pi[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c[4] = {0, 0, 0, 0};
        const int8_t* kb = ks + (k0 + 8 * j + g) * QS + 4 * t;
#pragma unroll
        for (int s = 0; s < KS; ++s)
          mma_s8(c, aq[s], ld32(kb + 32 * s), ld32(kb + 32 * s + 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // sf and sf - m rounded one at a time, as the plain version does:
          // an fma here would shift p by an ulp of sf and move round(p * 127)
          const float p = expf(__fsub_rn(__fmul_rn(float(c[e]), cscale), m[e >> 1]));
          l[e >> 1] += p;
          pi[j][e] = __float2int_rn(p * 127.0f);
        }
      }
      const uint32_t a[4] = {pack4(pi[0][0], pi[0][1], pi[1][0], pi[1][1]),
                             pack4(pi[0][2], pi[0][3], pi[1][2], pi[1][3]),
                             pack4(pi[2][0], pi[2][1], pi[3][0], pi[3][1]),
                             pack4(pi[2][2], pi[2][3], pi[3][2], pi[3][3])};
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int8_t* vb = vt + (8 * nd + g) * VS + k0 + 4 * t;
        mma_s8(acc[nd], a, ld32(vb), ld32(vb + 16));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    TIn* out = o + base + size_t(r0 + g) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      store2(out + 8 * nd, float(acc[nd][0]) * oscale / l[0],
             float(acc[nd][1]) * oscale / l[0]);
      store2(out + 8 * D + 8 * nd, float(acc[nd][2]) * oscale / l[1],
             float(acc[nd][3]) * oscale / l[1]);
    }
  }
}

template <typename TIn, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int T, float scale,
           cudaStream_t stream) {
  const int smem = smem_bytes<D>(T);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        int8_attn<TIn, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int8_attn<TIn, D><<<bh, kThreads, smem, stream>>>(
      static_cast<const TIn*>(q), static_cast<const TIn*>(k), static_cast<const TIn*>(v),
      static_cast<TIn*>(o), T, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [bh, T, D] contiguous, 16-byte-aligned, bf16 (is_f32 0) or f32;
// scale: the softmax scale (D^-1/2). Returns 0, a CUDA error code, or -1 for
// a shape the kernel does not take (T a multiple of 32 up to 256, D 32 or 64).
extern "C" int eo_int8_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                     int is_f32, int bh, int T, int D, float scale, int device,
                                     void* stream) {
  if (bh < 1 || T < 32 || T > kMaxT || T % 32 != 0 || (D != 32 && D != 64)) return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return D == 64 ? launch<float, 64>(q, k, v, o, bh, T, scale, st)
                   : launch<float, 32>(q, k, v, o, bh, T, scale, st);
  return D == 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, bh, T, scale, st)
                 : launch<__nv_bfloat16, 32>(q, k, v, o, bh, T, scale, st);
}
