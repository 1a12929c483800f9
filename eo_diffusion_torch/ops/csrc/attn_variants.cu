// Attention-variant probes for Hopper (sm_90a), bound through ctypes: one
// templated kernel with a plain C interface.
//
// Replaces the single-pass attention variants of
// tools/profile_attn_variants.py (`kern_A` :28, `kern_B` :38, `kern_C` :49,
// `kern_D` :56, launched by `run` :66, call :77) and the KV-chunked one of
// tools/profile_attn_variants2.py (`kern_chunked` :28, `run` :51, call :62).
// Each maps q, k, v [B, T, H, D] (q and k scaled by s = D^-1/4 rounded to
// the input dtype) to o [B, T, H, D] with S = (q s)(k s)^T in f32 and p
// rounded to bf16 before PV, rounding at the JAX functions' points:
//   A  m and l first, then PV on round(p / l)       (the TPU's shipped form)
//   B  PV on round(p), then / l                      (deferred normalisation:
//      K1's recipe, an online softmax over K/V tiles; kern_chunked is this
//      function at other tiles)
//   C  PV on round(S): no max, no exp                (wrong on purpose: the
//      cost of the softmax)
//   D  B with p = exp(S): no max                     (wrong for large scores:
//      the cost of the max)
// D is not padded to 128: the padding is a TPU lane workaround and the
// result is the same.
//
// Bound on the H100: 206 GFLOP at B 8, T 4096, H 8, D 48 (0.2085 ms at
// 989 TFLOP/s bf16; 100 MB of q/k/v/o, operations), for every variant. A
// cannot know l in one pass, so it sweeps K twice (statistics, then PV on
// the normalised p): 1.5 times the function's products.
//
// Design: K1's body (csrc/attention_fwd.cu) with the variant and the tile as
// parameters, so the probes time K1's loop with one piece changed. It is a
// copy of K1's loop, not K1's code: a change to K1's loop is ported here by
// hand and B re-timed against K1 at K1's tile (tools/profile_attn_variants.py,
// `vs_shipped`) before a "B against K1" number is read (ROADMAP queue 2,
// item 3a). A block
// of WARPS warps owns 32 WARPS query rows (32 a warp, two m16 tiles whose q
// fragments stay in registers; WARPS 4 is K1's 128 rows, 8 and 16 share each
// K/V load between 2x and 4x as many rows: the TPU's bq question on this
// card, where the 512-4096-row q tiles of the TPU do not fit a block's
// registers). K/V stream through two shared-memory stages of BK keys (64,
// K1's, or 128) with cp.async; the scores of 64 keys at a time
// sit in registers and turn into the PV A operand there; mma.sync m16n8k16
// bf16, f32 accumulators, softmax in base 2. WARPS 16 caps a thread at 128
// registers (65,536 on an SM), below K1's 172: that configuration spills,
// which is the card's answer to the TPU's largest q tiles. Any T (the
// ragged tail masked), D a multiple of 8 up to 64 (the UNet's 48 and 64 and
// the DiT's 64), bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace eo_tile;

enum Variant { kA = 0, kB = 1, kC = 2, kD = 3 };

constexpr int kSub = 64;  // keys of one register score tile
constexpr int kMT = 2;    // m16 query tiles a warp
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void *q, *k, *v;  // [B, T, H, D] contiguous
  void* out;              // [B, T, H, D] contiguous
  int H, T, D;
  float scale;
};

template <int DP>
__host__ __device__ constexpr int ld_of() {
  return DP + 8;  // +16 B a row: conflict-free ldmatrix
}

// keys [k0, k0 + rows) of the K (and, with_v, the V) plane into one stage,
// rows >= T and columns >= D zero-filled (D % 8 == 0: a 16-byte chunk is all
// in or out); a K row sits st elements after the one before
template <int DP, int NTHREADS>
__device__ __forceinline__ void issue_kv(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                         const __nv_bfloat16* kp, const __nv_bfloat16* vp,
                                         long long st, int k0, int rows, int T, int D,
                                         bool with_v) {
  constexpr int LD = ld_of<DP>(), kChunks = DP / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += NTHREADS) {
    const int r = i / kChunks, d = (i % kChunks) * 8;
    const bool in = k0 + r < T && d < D;
    const long long off = in ? (long long)(k0 + r) * st + d : 0;
    cp_async16(sK + r * LD + d, kp + off, in);
    if (with_v) cp_async16(sV + r * LD + d, vp + off, in);
  }
}

// k * s rounded to bf16, in place, for the chunks this thread copied (the
// copies are visible to the issuing thread after its wait)
template <int DP, int NTHREADS>
__device__ __forceinline__ void scale_k(__nv_bfloat16* sK, int rows, __nv_bfloat162 s2) {
  constexpr int LD = ld_of<DP>(), kChunks = DP / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += NTHREADS) {
    uint4* ptr = reinterpret_cast<uint4*>(sK + (i / kChunks) * LD + (i % kChunks) * 8);
    uint4 v = *ptr;  // one 16-byte load and store a chunk
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = __hmul2(e[k], s2);
    *ptr = v;
  }
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// the B operand (k16 x n8) of PV from V rows [key][d] in shared memory
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const __nv_bfloat16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(ptr))
               : "memory");
}

template <int DP, int WARPS, int VAR, int BK>
__global__ void __launch_bounds__(32 * WARPS) attn_variant(Params p) {
  constexpr int NTHREADS = 32 * WARPS;
  constexpr int LD = ld_of<DP>(), KS = DP / 16, NT = DP / 8, MT = kMT;
  constexpr int BQ = 16 * MT * WARPS;
  constexpr int stage = 2 * BK * LD;  // BK K rows + BK V rows, elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long st = (long long)p.H * p.D;  // token stride
  const long long base = ((long long)b * p.T * p.H + h) * p.D;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + base;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + base;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + base;
  const __nv_bfloat162 s2 = __float2bfloat162_rn(p.scale);
  const int n_tiles = (p.T + BK - 1) / BK;
  // A sweeps K twice: pass 0 the statistics (no V), pass 1 PV
  const int total = (VAR == kA ? 2 : 1) * n_tiles;

  // K/V tile 0 -> stage 0 in flight while q * s is staged behind it (from
  // stage 1 on), as K1 does
  issue_kv<DP, NTHREADS>(smem, smem + BK * LD, kp, vp, st, 0, BK, p.T, p.D, VAR != kA);
  cp_async_commit();
  {
    __nv_bfloat16* sQ = smem + stage;
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < BQ * kChunks; i += NTHREADS) {
      const int r = i / kChunks, d = (i % kChunks) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < p.T && d < p.D) {
        v = *reinterpret_cast<const uint4*>(qp + (long long)(q0 + r) * st + d);
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] = __hmul2(e[k], s2);
      }
      *reinterpret_cast<uint4*>(sQ + r * LD + d) = v;
    }
  }
  __syncthreads();
  uint32_t qa[MT][KS][4];  // the A operand: rows g, g + 8, columns 2 tq (+8)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const __nv_bfloat16* r0 = smem + stage + ((warp * MT + mt) * 16 + g) * LD + tq * 2;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[mt][kk][0] = ld_u32(r0 + kk * 16);
      qa[mt][kk][1] = ld_u32(r0 + 8 * LD + kk * 16);
      qa[mt][kk][2] = ld_u32(r0 + kk * 16 + 8);
      qa[mt][kk][3] = ld_u32(r0 + 8 * LD + kk * 16 + 8);
    }
  }
  __syncthreads();  // the q rows are free for K/V tile 1

  float o[MT][NT][4];
  float m[MT][2], l[MT][2], inv_l[MT][2];  // rows g and g + 8 of each m16 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) m[mt][r] = -INFINITY, l[mt][r] = 0.f, inv_l[mt][r] = 0.f;
  }

  for (int it = 0, kt = 0; it < total; ++it, kt = kt + 1 == n_tiles ? 0 : kt + 1) {
    const bool stats_only = VAR == kA && it < n_tiles;
    __nv_bfloat16* sK = smem + (it & 1) * stage;
    const __nv_bfloat16* sV = sK + BK * LD;
    if (it + 1 < total) {
      __nv_bfloat16* nK = smem + ((it + 1) & 1) * stage;
      issue_kv<DP, NTHREADS>(nK, nK + BK * LD, kp, vp, st, (kt + 1 == n_tiles ? 0 : kt + 1) * BK,
                             BK, p.T, p.D, !(VAR == kA && it + 1 < n_tiles));
    }
    cp_async_commit();  // possibly empty: one group a tile
    cp_async_wait<1>();
    scale_k<DP, NTHREADS>(sK, BK, s2);
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
          const uint32_t b0 = ld_u32(kr + kk * 16), b1 = ld_u32(kr + kk * 16 + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(s[mt][n], qa[mt][kk], b0, b1);
        }
      }
      // ragged tail: keys past T get p = 0 (C: their K and V rows are zero,
      // so their s is 0 and adds nothing)
      if (VAR != kC && k0 + kSub > p.T) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + n * 8 + tq * 2 + (e & 1) >= p.T) s[mt][n][e] = -INFINITY;
      }

      // s -> p in place, f32, base 2; the 4 threads of a group share a row
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (VAR == kC) continue;  // p = s
          float mb = 0.f;           // D: no max
          if (VAR == kB || stats_only) {
            float mx = -INFINITY;
#pragma unroll
            for (int n = 0; n < kSub / 8; ++n)
              mx = fmaxf(mx, fmaxf(s[mt][n][2 * r], s[mt][n][2 * r + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float mn = fmaxf(m[mt][r], mx);
            const float alpha = ex2((m[mt][r] - mn) * kLog2e);  // 0 on the first tile
            m[mt][r] = mn;
            l[mt][r] *= alpha;
            if (VAR == kB) {
#pragma unroll
              for (int n = 0; n < NT; ++n) {
                o[mt][n][2 * r] *= alpha;
                o[mt][n][2 * r + 1] *= alpha;
              }
            }
            mb = mn * kLog2e;
          } else if (VAR == kA) {
            mb = m[mt][r] * kLog2e;  // pass 1: the final max
          }
          float rs = 0.f;
#pragma unroll
          for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              float x = ex2(fmaf(s[mt][n][e], kLog2e, -mb));
              rs += x;
              if (VAR == kA && !stats_only) x *= inv_l[mt][r];  // round(p / l) below
              s[mt][n][e] = x;
            }
          if (VAR != kA || stats_only) {
            rs += __shfl_xor_sync(0xffffffffu, rs, 1);
            rs += __shfl_xor_sync(0xffffffffu, rs, 2);
            l[mt][r] += rs;
          }
        }
      if (stats_only) continue;

      // two n8 score tiles make one k16 A fragment of P (rounded to bf16)
      uint32_t pa[MT][kSub / 16][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < kSub / 16; ++j) {
          pa[mt][j][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
          pa[mt][j][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
          pa[mt][j][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
          pa[mt][j][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
        }
      // O += P V; V [key][d] is the k-outer B operand, each V fragment feeds
      // MT products
#pragma unroll
      for (int j = 0; j < kSub / 16; ++j) {
        const __nv_bfloat16* vr = sV + (c + j * 16 + (lane & 15)) * LD;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, vr + n * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(o[mt][n], pa[mt][j], b0, b1);
        }
      }
    }
    if (VAR == kA && it == n_tiles - 1) {  // the statistics are complete
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) inv_l[mt][r] = l[mt][r] == 0.f ? 0.f : 1.f / l[mt][r];
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  // epilogue: B and D divide by l here (A did before PV, C never does);
  // o [B, T, H, D] at row stride H D
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + base;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + (warp * MT + mt) * 16 + g + 8 * r;
      if (row >= p.T) continue;
      const float f = (VAR == kB || VAR == kD) ? (l[mt][r] == 0.f ? 0.f : 1.f / l[mt][r]) : 1.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = n * 8 + tq * 2;
        if (d < p.D)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * st + d) =
              __floats2bfloat162_rn(o[mt][n][2 * r] * f, o[mt][n][2 * r + 1] * f);
      }
    }
}

template <int DP, int WARPS, int VAR, int BK>
int launch(const Params& p, int bh, cudaStream_t st) {
  // two stages of K and V, bf16; q is staged from stage 1 on
  constexpr int BQ = 16 * kMT * WARPS;
  constexpr int rows = 4 * BK > 2 * BK + BQ ? 4 * BK : 2 * BK + BQ;
  constexpr int smem = 2 * rows * ld_of<DP>();
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        attn_variant<DP, WARPS, VAR, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.T + BQ - 1) / BQ, bh);
  attn_variant<DP, WARPS, VAR, BK><<<grid, 32 * WARPS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the tiles: every variant at 4 and 8 warps by 64 keys a stage; B, the tile
// sweep's, also at 16 warps (4x K1's rows) and 128 keys a stage
template <int DP, int WARPS>
int launch_tile(const Params& p, int bh, int var, int bk, cudaStream_t st) {
  if (var == kB) {
    if (bk == 64) return launch<DP, WARPS, kB, 64>(p, bh, st);
    return bk == 128 ? launch<DP, WARPS, kB, 128>(p, bh, st) : -1;
  }
  if constexpr (WARPS == 16) {
    return -1;
  } else {
    if (bk != 64) return -1;
    switch (var) {
      case kA: return launch<DP, WARPS, kA, 64>(p, bh, st);
      case kC: return launch<DP, WARPS, kC, 64>(p, bh, st);
      case kD: return launch<DP, WARPS, kD, 64>(p, bh, st);
      default: return -1;
    }
  }
}

template <int DP>
int launch_dp(const Params& p, int bh, int var, int warps, int bk, cudaStream_t st) {
  switch (warps) {
    case 4: return launch_tile<DP, 4>(p, bh, var, bk, st);
    case 8: return launch_tile<DP, 8>(p, bh, var, bk, st);
    case 16: return launch_tile<DP, 16>(p, bh, var, bk, st);
    default: return -1;
  }
}

}  // namespace

// q, k, v, out: bf16 [B, T, H, D] contiguous with 16-byte-aligned bases;
// variant 0-3 = A-D; warps 4 or 8 (32 warps query rows a block) by bk 64
// keys a K/V stage, and for B also warps 16 and bk 128; scale = D^-1/4
// rounded to bf16. Any T >= 1; D a multiple of 8 up to 64. Returns 0, a CUDA
// error code, or -1 for an argument it does not take.
extern "C" int eo_attention_variant(const void* q, const void* k, const void* v, void* out,
                                    int variant, int warps, int bk, int B, int T, int H, int D,
                                    float scale, int device, void* stream) {
  if (B < 1 || H < 1 || T < 1 || D < 8 || D > 64 || D % 8 || (long long)B * H > 65535 ||
      bk < kSub)
    return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.H = H;
  p.T = T;
  p.D = D;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_dp<16>(p, B * H, variant, warps, bk, st);
    case 32: return launch_dp<32>(p, B * H, variant, warps, bk, st);
    case 48: return launch_dp<48>(p, B * H, variant, warps, bk, st);
    case 64: return launch_dp<64>(p, B * H, variant, warps, bk, st);
    default: return -1;
  }
}
