// Weight gradient of a 3x3, stride-1, padding-1 convolution for Hopper (sm_90a)
// on wgmma and TMA, bound through ctypes. The bf16 body for channel counts that
// are multiples of 8; conv_wgrad.cu keeps the earlier mma.sync body (any C and
// Co, the narrow input and output convs among them) and the float32 kernel.
//
// Replaces the TPU kernel `_wgrad_kernel` (tools/prototype_wgrad_kernel.py:40,
// launched by `pallas_wgrad` at :59, call :65). Same function:
//
//   dW[ky, kx, c, o] = sum_{b, h, w} x_pad[b, h + ky, w + kx, c] * dy[b, h, w, o]
//
// x [B, H, W, C] and dy [B, H, W, Co] NHWC bf16, x_pad x with one zero pixel on
// every side, dW [3, 3, C, Co] f32 (HWIO), summed in f32 and rounded nowhere.
// Per tap it is a product with M = C, N = Co and a contraction over the B*H*W
// pixels: long K, small M and N.
//
// What bounds it on the H100: max(2*B*H*W*9*C*Co / 989e12, (|x| + |dy| + |dW|)
// / 3.35e12). At the JAX tool's shape (B 8, 256 x 256, C = Co = 128) that is
// 154.6 GFLOP, 0.156 ms, against 268 MB, 0.080 ms: the tensor cores. The
// design:
//   * grid (C/64 x Co/64 tile pairs, S splits of the pixels); a block owns one
//     64 x 64 (c, o) tile of all nine taps and a contiguous run of the image's
//     8 x 16-pixel dy tiles (image-major, then rows, then columns);
//   * a ring of kStages stages, each a dy tile [8 * 16 pixels][64 o] and its
//     haloed x tile [10 * 18 pixels][64 c], each one TMA box of a 4-D
//     (channel, w, h, b) tensor map, 128-byte rows swizzled over 128 bytes.
//     The x box starts one pixel up and left of the dy tile: TMA zero-fills
//     every coordinate outside the image (the negative ones too), so the
//     padding and the ragged edges cost nothing and no padded copy of x exists.
//     Channels past C or Co read as zeros too;
//   * three consumer warpgroups, one per kx, each holding the three taps (ky,
//     kx), ky = 0..2, as 64 x 64 f32 accumulators (96 registers a thread).
//     A k16 step is one 16-pixel row of the dy tile: B = dy rows (pixels x o,
//     MN-major, read by wgmma from shared memory through a descriptor whose
//     start is 2048 bytes a row, on the swizzle atom). A = the x pixels of the
//     tap's shift, (row h + ky, columns kx .. kx + 15) of the haloed tile: a
//     register fragment loaded by ldmatrix.trans, whose row addresses apply
//     the tap's shift and the 128-byte swizzle in software. A wgmma
//     descriptor starting kx pixel rows into the tile would start off the
//     1024-byte swizzle atom; the fragment sidesteps that, and each x row's
//     fragment feeds the three taps of its warpgroup (x row r is row r - ky of
//     dy for ky = 0, 1, 2), so shared memory serves 2 KB of fragment and 6 KB
//     of dy for three m64n64k16 products, about 0.7 of its rate at the tensor
//     cores' peak;
//   * thread 0 also keeps the ring full: it refills the stage the three
//     warpgroups have all released (12 warp arrivals on its empty barrier);
//   * with S > 1, each block writes its partial tile to an f32 workspace
//     [S, 9, C, Co] and a second kernel sums the S partials in a fixed order:
//     the result is the same bits on every run (no atomics). The wrapper's
//     planner weighs the waves of blocks against the workspace's bytes.
//     Thread-block clusters that summed their partials through distributed
//     shared memory were tried and dropped: clusters of 4 and 8 fit 120 blocks
//     at once, not 132, and took up to 1.9 times as long at the JAX tool's
//     shape; pairs took 12 % less at the 32 x 32 C512 sites only (H100
//     80GB HBM3, 700 W).
// Not done yet: a persistent grid, wider o tiles (N 128) for fewer dy reads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace eo_wg;

constexpr int kTH = 8, kTW = 16;             // dy tile: 8 rows x 16 columns
constexpr int kXH = kTH + 2, kXW = kTW + 2;  // x tile with its one-pixel halo
constexpr int kCT = 64;                      // channels a side of the (c, o) tile
constexpr int kRow = kCT * 2;                // bytes a pixel row of a tile
constexpr int kDyBytes = kTH * kTW * kRow;   // 16384: a multiple of 1024
constexpr int kXBytes = kXH * kXW * kRow;    // 23040
constexpr int kStageBytes = (kDyBytes + kXBytes + 1023) / 1024 * 1024;
constexpr int kStages = 5;
constexpr int kThreads = 384;                // three consumer warpgroups, one per kx
constexpr int kSmemLimit = 232448;           // a block's opt-in shared memory on the H100
constexpr int kSmem = kStages * kStageBytes + 1024 + 1024;  // barriers, 1024-byte alignment
static_assert(kSmem <= kSmemLimit, "shared memory");
static_assert(kDyBytes % 1024 == 0, "the x box starts on a swizzle atom");
constexpr int kSumThreads = 256;
constexpr int kMaxDevices = 64;

// wgmma_tile.cuh's mbar_wait that traps after about 2^33 cycles (seconds): a
// lost TMA transaction or arrival is a launch error, never a hang
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 33)) __trap();
  }
}

struct Params {
  float* dst;  // [S, 9, C, Co] partials, or dW itself when S == 1
  int C, Co;
  int tiles_h, tiles_w, tiles_o;
  int n_tiles;  // B * tiles_h * tiles_w
  int S;
};

__global__ void __launch_bounds__(kThreads, 1)
    wgrad_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
               const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int c0 = (blockIdx.x / p.tiles_o) * kCT, o0 = (blockIdx.x % p.tiles_o) * kCT;
  const int split = blockIdx.y;
  const int t_begin = static_cast<int>((long long)p.n_tiles * split / p.S);
  const int n_local = static_cast<int>((long long)p.n_tiles * (split + 1) / p.S) - t_begin;
  const int kx = threadIdx.x / 128;  // this warpgroup's column of taps
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);  // lane 0 of each of the 12 warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  // dy tile t_begin + i and its haloed x tile into stage i % kStages
  auto issue = [&](int i) {
    const int s = i % kStages;
    const int tile = t_begin + i;
    const int per_img = p.tiles_h * p.tiles_w;
    const int b = tile / per_img, rem = tile % per_img;
    const int h0 = (rem / p.tiles_w) * kTH, w0 = (rem % p.tiles_w) * kTW;
    unsigned char* st = base + s * kStageBytes;
    mbar_arrive_expect_tx(&full[s], kDyBytes + kXBytes);
    tma_load_4d(st, &tdy, &full[s], o0, w0, h0, b);
    tma_load_4d(st + kDyBytes, &tx, &full[s], c0, w0 - 1, h0 - 1, b);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < n_local && i < kStages; ++i) issue(i);

  float acc[3][32];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[ky][e] = 0.f;

  // this lane's ldmatrix.trans row (mma_tile.cuh's load_a order: piece j =
  // lane / 8 is (c 0-7 | 8-15) x (pixel 0-7 | 8-15) of the warp's 16 c)
  const int j = lane >> 3;
  const int kofs = kx + (j >> 1) * 8 + (lane & 7);  // pixel column in the x tile
  const int chunk = 2 * warp + (j & 1);             // 16-byte column of a 128-byte row

  for (int i = 0; i < n_local; ++i) {
    const int s = i % kStages;
    if (threadIdx.x == 0 && i >= 1 && i - 1 + kStages < n_local) {
      const int sp = (i - 1) % kStages;  // released by all three warpgroups?
      wait_or_trap(&empty[sp], ((i - 1) / kStages) & 1);
      issue(i - 1 + kStages);
    }
    __syncwarp();
    wait_or_trap(&full[s], (i / kStages) & 1);
    const unsigned char* st = base + s * kStageBytes;
    const unsigned char* xs = st + kDyBytes;

    uint32_t a[kXH][4];
#pragma unroll
    for (int hh = 0; hh < kXH; ++hh) {
      const int px = hh * kXW + kofs;
      eo_tile::ldsm_x4_trans(
          a[hh], reinterpret_cast<const bf16*>(xs + px * kRow + ((chunk ^ (px & 7)) << 4)));
    }
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < kXH; ++hh)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int h = hh - ky;  // the dy row x row hh meets at tap (ky, kx)
        if (h >= 0 && h < kTH)
          wgmma_m64n64k16_rs_mn(acc[ky], a[hh],
                                desc_sw<64>(st + h * kTW * kRow, kDyBytes, 8 * kRow), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) reg_fence(acc[ky]);
    reg_fence(a);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // tap (ky, kx): rows c, columns o (wgmma_tile.cuh's accumulator layout)
  const int g = lane >> 2, tq = lane & 3;
  const long long plane = (long long)p.C * p.Co;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    float* dst = p.dst + ((long long)split * 9 + ky * 3 + kx) * plane;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = c0 + 16 * warp + g + 8 * r;
      if (c >= p.C) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int o = o0 + 8 * n + 2 * tq;  // Co even: o + 1 < Co when o < Co
        if (o < p.Co)
          *reinterpret_cast<float2*>(dst + (long long)c * p.Co + o) =
              make_float2(acc[ky][4 * n + 2 * r], acc[ky][4 * n + 2 * r + 1]);
      }
    }
  }
}

// dW[i] = sum over s of ws[s, i], s in order, four elements a thread
__global__ void __launch_bounds__(kSumThreads) sum_splits4(const float4* __restrict__ ws,
                                                           float4* __restrict__ out,
                                                           long long n4, int S) {
  for (long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kSumThreads) {
    float4 v = ws[i];
    for (int s = 1; s < S; ++s) {
      const float4 w = ws[(long long)s * n4 + i];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    out[i] = v;
  }
}

// a (C, W, H, B) view of a contiguous NHWC bf16 tensor, boxes of 64 channels x
// box_w x box_h pixels of one image, swizzled over 128 bytes; coordinates
// outside the tensor read as zeros
bool encode_nhwc(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int box_w,
                 int box_h) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                           (cuuint64_t)H * W * C * 2};
  cuuint32_t box[4] = {(cuuint32_t)kCT, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

// x [B, H, W, C] and dy [B, H, W, Co] contiguous bf16 on the device, 16-byte-
// aligned bases, C and Co multiples of 8; out [3, 3, C, Co] f32; ws an f32
// workspace of S * 9 * C * Co elements (unused when S is 1), S at most the
// number of 8 x 16-pixel dy tiles. Returns 0, a CUDA error code, -1 for an
// argument it does not take, -2 when the driver refuses a tensor map.
extern "C" int eo_conv_wgrad_sm90(const void* x, const void* dy, float* out, float* ws, int B,
                                  int H, int W, int C, int Co, int S, int device,
                                  void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 8 || Co < 8 || C % 8 != 0 || Co % 8 != 0 || S < 1)
    return -1;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return -1;
  Params p;
  p.C = C;
  p.Co = Co;
  p.tiles_h = (H + kTH - 1) / kTH;
  p.tiles_w = (W + kTW - 1) / kTW;
  p.tiles_o = (Co + kCT - 1) / kCT;
  const long long n_tiles = (long long)B * p.tiles_h * p.tiles_w;
  const long long pairs = (long long)((C + kCT - 1) / kCT) * p.tiles_o;
  if (n_tiles >= (1LL << 31) || S > n_tiles || pairs > 0x7fffffff || S > 65535) return -1;
  p.n_tiles = static_cast<int>(n_tiles);
  p.S = S;
  p.dst = S == 1 ? out : ws;
  if (device < 0 || device >= kMaxDevices) return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  CUtensorMap mx, mdy;
  if (!encode_nhwc(&mx, x, B, H, W, C, kXW, kXH) ||
      !encode_nhwc(&mdy, dy, B, H, W, Co, kTW, kTH))
    return -2;
  static bool opted_in[kMaxDevices] = {};
  if (!opted_in[device]) {  // the shared-memory opt-in, once a device
    const cudaError_t err =
        cudaFuncSetAttribute(wgrad_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  wgrad_sm90<<<dim3(static_cast<unsigned>(pairs), S), kThreads, kSmem, st>>>(mx, mdy, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const long long n4 = 9LL * C * Co / 4;
  const long long blocks = (n4 + kSumThreads - 1) / kSumThreads;
  sum_splits4<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024), kSumThreads, 0, st>>>(
      reinterpret_cast<const float4*>(ws), reinterpret_cast<float4*>(out), n4, S);
  return static_cast<int>(cudaGetLastError());
}
