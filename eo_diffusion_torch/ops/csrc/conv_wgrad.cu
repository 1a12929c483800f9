// Weight gradient of a 3x3, stride-1, padding-1 convolution for Hopper (sm_90a),
// bound through ctypes.
//
// Replaces the TPU kernel `_wgrad_kernel` (tools/prototype_wgrad_kernel.py:40,
// launched by `pallas_wgrad` at :59, call :65). Same function:
//
//   dW[ky, kx, c, o] = sum_{b, h, w} x_pad[b, h + ky, w + kx, c] * dy[b, h, w, o]
//
// x [B, H, W, C] and dy [B, H, W, Co] NHWC (bf16 or f32), x_pad x with one
// zero pixel on every side, dW [3, 3, C, Co] f32 (HWIO). Per tap it is a
// product with M = C, N = Co and a contraction over the B*H*W pixels.
//
// What bounds it on the H100: max(2*B*H*W*9*C*Co / 989e12, (|x| + |dy| + |dW|)
// / 3.35e12). At the JAX tool's shape (B 8, 256 x 256, C = Co = 128, bf16)
// that is 154.6 GFLOP, 0.156 ms, against 268 MB, 0.080 ms: operations. At
// the UNet's narrow ends (C 6 or Co 3) the bytes bound.
//
// Design. The TPU kernel walks a sequential grid into one VMEM-resident
// [9, C, Co] accumulator over three XLA-made ky-shifted copies of x. Here
// there are only 9 * ceil(C/64) * ceil(Co/64) output tiles (36 at the
// headline) for 132 SMs, so the pixel contraction is split across blocks:
//   * grid (C/64 x Co/64 tile pairs, S splits); a block owns one 64 x 64
//     (c, o) tile of all nine taps and a contiguous run of the image's
//     8 x 16-pixel dy tiles (image-major, rows, then columns, so neighbours
//     share their halo in L2);
//   * per dy tile it loads the matching 10 x 18-pixel x tile (one-pixel halo;
//     zero padding and masked channels come from zero-filled cp.async copies)
//     and the dy tile into shared memory once, double-buffered; all nine taps
//     are formed from that one tile by shifting ldmatrix row addresses, so
//     x and dy are read once for the nine taps and no shifted copy exists;
//   * 9 warps, one per tap, each holding its 64 x 64 f32 tile in registers;
//     a k16 step is one row of 16 dy pixels: A = the x rows of the tap's
//     shift (stored [pixel][c], ldmatrix.trans), B = the dy rows (stored
//     [pixel][o], ldmatrix.trans), 32 mma.sync m16n8k16 bf16 a step;
//   * with S > 1, each block writes its partial tile to an f32 workspace
//     [S, 9, C, Co] and a second kernel sums the S partials in a fixed
//     order: the result is the same bits on every run (no atomics);
//   * an operand whose channels are not a multiple of 8 (the UNet's input
//     conv C 6, output conv Co 3) takes synchronous element loads of its
//     real channels instead of 16-byte copies (the tile's other columns are
//     zeroed once);
//   * f32 inputs take a plain FMA kernel (one thread per (tap, c, o) and
//     split), kept for correctness checks, not speed.
// Not done yet: wgmma, TMA, more than one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace eo_tile;

constexpr int kTH = 8, kTW = 16;              // dy tile: 8 rows x 16 columns
constexpr int kXH = kTH + 2, kXW = kTW + 2;   // x tile with its one-pixel halo
constexpr int kCT = 64;                       // channels of a (c, o) tile side
constexpr int kLD = kCT + 8;                  // shared row stride, elements
constexpr int kWarps = 9;                     // one per tap
constexpr int kThreads = 32 * kWarps;
constexpr int kXElems = kXH * kXW * kLD;
constexpr int kStage = kXElems + kTH * kTW * kLD;
constexpr int kSmemBytes = 2 * kStage * 2;    // two stages of bf16
constexpr int kF32Threads = 256;

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dy;
  float* dst;  // [S, 9, C, Co] partials, or dW itself when S == 1
  int H, W, C, Co;
  int tiles_h, tiles_w;
  long long n_tiles;
  int S;
};

// Copies of dy tile t (and its x tile) into one stage; pixels outside the
// image are zero. VX / VD: x / dy rows start on 16 bytes (C / Co a multiple
// of 8), so 16-byte cp.async copies with zero fill, which also zero the
// channels past C / Co; else element loads of the real channels only (the
// columns past them were zeroed once, at the kernel's start).
template <bool VX, bool VD>
__device__ __forceinline__ void load_tile(const Params& p, __nv_bfloat16* xs,
                                          __nv_bfloat16* ds, long long t, int c0, int o0) {
  const int per_img = p.tiles_h * p.tiles_w;
  const int b = static_cast<int>(t / per_img);
  const int rem = static_cast<int>(t % per_img);
  const int h0 = (rem / p.tiles_w) * kTH, w0 = (rem % p.tiles_w) * kTW;
  const long long img = (long long)b * p.H * p.W;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (VX) {
    for (int i = threadIdx.x; i < kXH * kXW * (kCT / 8); i += kThreads) {
      const int px = i >> 3, c = c0 + (i & 7) * 8;
      const int h = h0 - 1 + px / kXW, w = w0 - 1 + px % kXW;
      const bool in = h >= 0 && h < p.H && w >= 0 && w < p.W && c < p.C;
      const __nv_bfloat16* src = in ? p.x + (img + (long long)h * p.W + w) * p.C + c : p.x;
      cp_async16(xs + px * kLD + (i & 7) * 8, src, in);
    }
  } else {
    const int nc = min(kCT, p.C - c0);
    for (int i = threadIdx.x; i < kXH * kXW * nc; i += kThreads) {
      const int px = i / nc, c = i % nc;
      const int h = h0 - 1 + px / kXW, w = w0 - 1 + px % kXW;
      const bool in = h >= 0 && h < p.H && w >= 0 && w < p.W;
      xs[px * kLD + c] = in ? p.x[(img + (long long)h * p.W + w) * p.C + c0 + c] : zero;
    }
  }
  if (VD) {
    for (int i = threadIdx.x; i < kTH * kTW * (kCT / 8); i += kThreads) {
      const int px = i >> 3, o = o0 + (i & 7) * 8;
      const int h = h0 + px / kTW, w = w0 + px % kTW;
      const bool in = h < p.H && w < p.W && o < p.Co;
      const __nv_bfloat16* src = in ? p.dy + (img + (long long)h * p.W + w) * p.Co + o : p.dy;
      cp_async16(ds + px * kLD + (i & 7) * 8, src, in);
    }
  } else {
    const int no = min(kCT, p.Co - o0);
    for (int i = threadIdx.x; i < kTH * kTW * no; i += kThreads) {
      const int px = i / no, o = i % no;
      const int h = h0 + px / kTW, w = w0 + px % kTW;
      const bool in = h < p.H && w < p.W;
      ds[px * kLD + o] = in ? p.dy[(img + (long long)h * p.W + w) * p.Co + o0 + o] : zero;
    }
  }
}

template <bool VX, bool VD>
__global__ void __launch_bounds__(kThreads, 1) wgrad_bf16(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  if (!VX || !VD) {  // element loads write the real channels only: zero the rest once
    for (int i = threadIdx.x; i < 2 * kStage / 8; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  const int tiles_o = (p.Co + kCT - 1) / kCT;
  const int c0 = (blockIdx.x / tiles_o) * kCT, o0 = (blockIdx.x % tiles_o) * kCT;
  const int s = blockIdx.y;
  const long long t_begin = p.n_tiles * s / p.S, t_end = p.n_tiles * (s + 1) / p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ky = warp / 3, kx = warp % 3;  // this warp's tap

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;

  if (t_begin < t_end) {
    load_tile<VX, VD>(p, smem, smem + kXElems, t_begin, c0, o0);
    cp_async_commit();
  }
  for (long long t = t_begin; t < t_end; ++t) {
    const int stage = static_cast<int>((t - t_begin) & 1);
    const __nv_bfloat16* xs = smem + stage * kStage;
    const __nv_bfloat16* ds = xs + kXElems;
    if (t + 1 < t_end) {
      __nv_bfloat16* nx = smem + (stage ^ 1) * kStage;
      load_tile<VX, VD>(p, nx, nx + kXElems, t + 1, c0, o0);
    }
    cp_async_commit();  // possibly empty: one group per tile
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();

#pragma unroll 1
    for (int ks = 0; ks < kTH; ++ks) {  // dy row ks of the tile: 16 pixels
      uint32_t bf[8][2];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b2[2][2];
        load_b2<true>(b2, ds + ks * kTW * kLD + np * 16, kLD, lane);
        bf[2 * np][0] = b2[0][0];
        bf[2 * np][1] = b2[0][1];
        bf[2 * np + 1][0] = b2[1][0];
        bf[2 * np + 1][1] = b2[1][1];
      }
      // x pixels (ks + ky, kx + i), i = 0..15, of the haloed tile
      const __nv_bfloat16* xa = xs + ((ks + ky) * kXW + kx) * kLD;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        load_a<true>(a, xa + mt * 16, kLD, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
    __syncthreads();  // this stage is refilled with tile t + 2 next
  }

  // the warp's 64 x 64 tile of tap `warp`: rows c, columns o
  const int g = lane >> 2, tq = lane & 3;
  float* dst = p.dst + ((long long)s * 9 + warp) * p.C * p.Co;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = c0 + mt * 16 + g + 8 * r;
      if (c >= p.C) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int o = o0 + nt * 8 + tq * 2;
        if (o < p.Co) dst[(long long)c * p.Co + o] = acc[mt][nt][2 * r];
        if (o + 1 < p.Co) dst[(long long)c * p.Co + o + 1] = acc[mt][nt][2 * r + 1];
      }
    }
}

// f32 inputs: thread (tap, c, o) of split blockIdx.y sums its pixels in order
__global__ void __launch_bounds__(kF32Threads) wgrad_f32(const float* __restrict__ x,
                                                         const float* __restrict__ dy,
                                                         float* __restrict__ dst, int B, int H,
                                                         int W, int C, int Co, int S) {
  const long long n_out = 9LL * C * Co;
  const long long idx = (long long)blockIdx.x * kF32Threads + threadIdx.x;
  if (idx >= n_out) return;
  const int tap = static_cast<int>(idx / ((long long)C * Co));
  const int c = static_cast<int>((idx / Co) % C), o = static_cast<int>(idx % Co);
  const int ky = tap / 3, kx = tap % 3;
  const long long n_px = (long long)B * H * W;
  const int s = blockIdx.y;
  float sum = 0.f;
  for (long long px = n_px * s / S; px < n_px * (s + 1) / S; ++px) {
    const int w = static_cast<int>(px % W);
    const long long bh = px / W;
    const int h = static_cast<int>(bh % H);
    const int hh = h + ky - 1, ww = w + kx - 1;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
    sum = fmaf(x[((bh - h + hh) * W + ww) * C + c], dy[px * Co + o], sum);
  }
  dst[(long long)s * n_out + idx] = sum;
}

// dW[i] = sum over s of ws[s, i], s in order
__global__ void sum_splits(const float* __restrict__ ws, float* __restrict__ out, long long n,
                           int S) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += ws[(long long)s * n + i];
    out[i] = v;
  }
}

}  // namespace

// x [B, H, W, C] and dy [B, H, W, Co] contiguous on the device (bf16 with
// is_f32 0, else f32; 16-byte-aligned bases); out [3, 3, C, Co] f32; ws an
// f32 workspace of S * 9 * C * Co elements (unused when S is 1). S splits the
// pixel contraction: of the bf16 kernel's dy tiles (at most their count), or
// of the f32 kernel's pixels. Returns 0, a CUDA error code, or -1 for an
// argument it does not take.
extern "C" int eo_conv_wgrad(const void* x, const void* dy, float* out, float* ws, int is_f32,
                             int B, int H, int W, int C, int Co, int S, int device,
                             void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || Co < 1 || S < 1) return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_out = 9LL * C * Co;
  float* dst = S == 1 ? out : ws;
  if (is_f32) {
    const dim3 grid(static_cast<unsigned>((n_out + kF32Threads - 1) / kF32Threads), S);
    wgrad_f32<<<grid, kF32Threads, 0, st>>>(static_cast<const float*>(x),
                                            static_cast<const float*>(dy), dst, B, H, W, C,
                                            Co, S);
  } else {
    Params p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.dy = static_cast<const __nv_bfloat16*>(dy);
    p.dst = dst;
    p.H = H;
    p.W = W;
    p.C = C;
    p.Co = Co;
    p.tiles_h = (H + kTH - 1) / kTH;
    p.tiles_w = (W + kTW - 1) / kTW;
    p.n_tiles = (long long)B * p.tiles_h * p.tiles_w;
    if (S > p.n_tiles) return -1;
    p.S = S;
    const dim3 grid(((C + kCT - 1) / kCT) * ((Co + kCT - 1) / kCT), S);
    const bool vx = C % 8 == 0, vd = Co % 8 == 0;
    auto kernel = vx ? (vd ? wgrad_bf16<true, true> : wgrad_bf16<true, false>)
                     : (vd ? wgrad_bf16<false, true> : wgrad_bf16<false, false>);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, kSmemBytes, st>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const long long blocks = (n_out + 255) / 256;
  sum_splits<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024), 256, 0, st>>>(ws, out,
                                                                                   n_out, S);
  return static_cast<int>(cudaGetLastError());
}
