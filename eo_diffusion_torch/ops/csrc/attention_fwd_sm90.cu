// Self-attention forward for Hopper (sm_90a) on wgmma and TMA, bound through
// ctypes. The bf16 body behind both forward entries of the port.
//
// Replaces the same three TPU kernels as attention_fwd.cu, which keeps the
// earlier mma.sync body (entries *_mma) and the float32 kernel:
//   * `_qkv_layout_kernel_tpv` / `_qkv_layout_kernel` (K1,
//     eo_diffusion_tpu/ops/attention.py:738 / :697, launched by
//     `_qkv5_fwd_impl` at :797): q, k, v read from the fused projection;
//   * `_resident_kernel` (K2, :271) and `_flash_kernel` (K3, :227), the
//     resident and grid-tiled branches of `_flash_fwd_impl` (:333), which
//     pads D to a multiple of 128 and so takes any head dim.
// It computes what attention_fwd.cu computes:
//
//   o = softmax((q*s) (k*s)^T) v,   s = D^-1/4 rounded to bf16,
//
// with q*s and k*s rounded to bf16, f32 scores, running max m, running sum l
// and accumulator, p rounded to bf16 before PV, the normalisation deferred to
// the end, the optional row logsumexp lse [B*H, T] f32, and the empty-row
// convention (l = 0 gives o = 0 and lse = +0.7*FLT_MAX). Head dims: any
// multiple of 8 up to 256 (wgmma's N). o is [B, T, H, D] contiguous.
//
// What bounds it on the H100: 4 B H T^2 D operations against 4 B T H D bf16
// values moved; at the clouds UNet's ds-4 shape (B 8, T 4096, H 8, D 48)
// about 2000 operations a byte, far above the card's ~295: the tensor cores
// bound it (0.21 ms there), and after them the exponentials (one a score,
// 16 a cycle an SM on the special-function units). The design:
//   * one block per (128 query rows, batch*head), three warpgroups: a
//     producer and two consumers of 64 query rows each (setmaxnreg moves the
//     producer's registers to the consumers);
//   * q, k and v are read through TMA tensor maps, one per plane, as 4-D
//     views (D, T, H, B) of their strides, so the fused projection in either
//     head order and three separate [B, T, H, D] tensors take the same path
//     and nothing is copied. A box is 64 columns wide (128 bytes, swizzled
//     128B): D is padded to a multiple of 64 by the TMA's zero fill (D 160
//     runs as 192, D 256 as four chunks). D 48, the clouds UNet's ds-4 head,
//     is not padded: three boxes of 16 columns swizzled over 32 bytes
//     (kD48Chunks16 below). Rows past T are zero-filled too;
//   * K/V tiles of BK keys (128 up to D 128, 64 above, where the f32
//     accumulator of a 64 x 256 tile takes 128 registers a thread) stream
//     through a ring of 2-4 stages with full/ready/empty mbarriers. One
//     producer warp issues the loads; the other three scale each K tile by s
//     in shared memory, 16 bytes at a time, (and the q tile once), so k*s
//     rounds to bf16 as the contract says and no pre-pass writes a copy;
//   * QK^T is wgmma m64n{BK}k16 with q and k from shared memory (K-major). The
//     score accumulator is packed to bf16 in registers and is the A operand
//     of PV (wgmma m64n64k16, one per 64 output columns; m64n48k16 at D 48),
//     v from shared memory MN-major: p never leaves the registers;
//   * each consumer issues QK^T of tile j together with PV of tile j-1, then
//     runs the softmax of tile j while PV is on the tensor cores; the two
//     consumers take turns issuing through two named barriers, so one's
//     exp, sum and rescale overlap the other's products;
//   * the softmax runs in base 2 (one FFMA and one ex2 a score); keys past T
//     are masked to -inf on the last tile; rows past T are not stored.
// Not done yet: TMA stores of o, a persistent schedule, more than two
// consumer warpgroups (fewer K/V re-reads from L2).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace eo_wg;

constexpr int kBQ = 128;              // query rows a block: two consumers of 64
constexpr int kThreads = 384;         // producer warpgroup + two consumer warpgroups
constexpr int kScalers = 96;          // producer warps 1-3
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// A block starts with 65536 / 384 = 168 registers a thread, and
// setmaxnreg.inc waits until the registers it asks for are free: what the
// producer gives up must cover what the consumers take, or they wait forever
static_assert(128 * (168 - kProducerRegs) >= 256 * (kConsumerRegs - 168), "register budget");
constexpr float kFullyMaskedLse = 0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;    // a block's opt-in shared memory on the H100
// D 48 (the clouds UNet's ds-4 head) runs unpadded, as three 16-column
// chunks swizzled over 32 bytes (three TMA boxes an operand, one m64n48 PV
// product), not padded to one 64-column chunk (TMA zero fill, a third more
// tensor work): on the H100 the same bits in 3-5 % less time at B8 T4096 H8
// and 6-9 % less at T 16384 (tools/profile_attn_fwd_sm90.py; PERF.md)
constexpr bool kD48Chunks16 = true;
// K/V stages in the ring at most (as many as fit up to this: 4 at D <= 64, 3
// at D 128 and 192, 2 at 256). On the H100 (tools/profile_attn_fwd_sm90.py,
// two runs) 3, 4 and 6 stages came within 2 % of each other at D 48 and 64;
// 2 took 20-31 % more
constexpr int kMaxStages = 4;

// tiling for head dims padded to DP, in chunks of AW columns swizzled over
// AW * 2 bytes (wgmma_tile.cuh)
template <int DP, int AW>
struct Tile {
  static_assert(DP % AW == 0 && (AW == 64 || DP == 48), "64-column chunks, or D 48 in 16s");
  static constexpr int CH = DP / AW;                 // chunks
  static constexpr int ROW = AW * 2;                 // bytes a chunk row
  static constexpr int ATOM = 8 * ROW;               // bytes of 8 rows: SBO
  static constexpr int BK = DP <= 128 ? 128 : 64;    // keys a K/V stage
  static constexpr int Q_BYTES = kBQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;       // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // as many stages as fit, up to kMaxStages: a stage is held from its load
  // until PV of the next tile has read its V, so S stages leave about S - 2
  // tiles of compute to hide a load behind
  static constexpr int FIT = (kSmemLimit - Q_BYTES - 2048) / STAGE_BYTES;
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static_assert(STAGES >= 2, "two stages at least");
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFFSET + 1024 + 1024;  // barriers, 1024-byte alignment
  static_assert(SMEM <= kSmemLimit, "shared memory");
};

struct Params {
  void* out;   // [B, T, H, D] contiguous bf16
  float* lse;  // [B*H, T] f32 or null
  int T, H, D;
  float scale;  // s, already a bf16 value
};

struct Bars {
  uint64_t q_full, q_ready;
  uint64_t kv_full[kMaxStages], kv_ready[kMaxStages], kv_empty[kMaxStages];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = (q s)(k s)^T for this warpgroup's 64 rows and one K tile
template <int DP, int AW>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<DP, AW>::BK / 2], const bf16* sq,
                                         const bf16* sk) {
  using Tl = Tile<DP, AW>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk / (AW / 16), off = (kk % (AW / 16)) * 16;  // chunk, elements into it
    const uint64_t da = desc_sw<AW>(sq + c * kBQ * AW + off, 16, Tl::ATOM);
    const uint64_t db = desc_sw<AW>(sk + c * Tl::BK * AW + off, 16, Tl::ATOM);
    if constexpr (Tl::BK == 128)
      wgmma_m64n128k16_ss(sc, da, db, kk > 0);
    else
      wgmma_m64n64k16_ss(sc, da, db, kk > 0);
  }
}

// O += P V for one V tile, P as bf16 A fragments: one m64n64 product per
// 64-column chunk, or one m64n48 across the three 16-column chunks of D 48
template <int DP, int AW>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&pa)[Tile<DP, AW>::BK / 16][4],
                                         const bf16* sv) {
  using Tl = Tile<DP, AW>;
#pragma unroll
  for (int kc = 0; kc < Tl::BK / 16; ++kc) {
    if constexpr (AW == 64) {
#pragma unroll
      for (int c = 0; c < Tl::CH; ++c)
        wgmma_m64n64k16_rs_mn(
            o + 32 * c, pa[kc],
            desc_sw<AW>(sv + c * Tl::BK * AW + kc * 16 * AW, Tl::BK * Tl::ROW, Tl::ATOM), 1);
    } else {
      wgmma_m64n48k16_rs_mn(o, pa[kc],
                            desc_sw<AW>(sv + kc * 16 * AW, Tl::BK * Tl::ROW, Tl::ATOM), 1);
    }
  }
}

template <int DP, int AW>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using Tl = Tile<DP, AW>;
  constexpr int BK = Tl::BK;
  constexpr int S = Tl::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  auto stage_k = [&](int s) {
    return reinterpret_cast<bf16*>(base + Tl::Q_BYTES + s * Tl::STAGE_BYTES);
  };
  auto stage_v = [&](int s) { return stage_k(s) + BK * DP; };
  Bars& bar = *reinterpret_cast<Bars*>(base + Tl::BAR_OFFSET);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBQ;
  const int n_tiles = (p.T + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&bar.q_full, 1);
    mbar_init(&bar.q_ready, kScalers);
    for (int s = 0; s < S; ++s) {
      mbar_init(&bar.kv_full[s], 1);
      mbar_init(&bar.kv_ready[s], kScalers);
      mbar_init(&bar.kv_empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0 loads, warps 1-3 scale --------------------------
    setmaxnreg_dec<kProducerRegs>();
    const int warp = threadIdx.x / 32;
    if (warp == 0) {
      if (threadIdx.x == 0) {
        mbar_arrive_expect_tx(&bar.q_full, Tl::Q_BYTES);
        for (int c = 0; c < Tl::CH; ++c)
          tma_load_4d(sQ + c * kBQ * AW, &tq, &bar.q_full, c * AW, q0, h, b);
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % S;
          if (j >= S) mbar_wait(&bar.kv_empty[s], ((j / S) - 1) & 1);
          mbar_arrive_expect_tx(&bar.kv_full[s], Tl::STAGE_BYTES);
          for (int c = 0; c < Tl::CH; ++c) {
            tma_load_4d(stage_k(s) + c * BK * AW, &tk, &bar.kv_full[s], c * AW, j * BK, h, b);
            tma_load_4d(stage_v(s) + c * BK * AW, &tv, &bar.kv_full[s], c * AW, j * BK, h, b);
          }
        }
      }
    } else {
      const int i = threadIdx.x - 32;
      const __nv_bfloat162 s2 = __float2bfloat162_rn(p.scale);
      mbar_wait(&bar.q_full, 0);
      scale_tile(sQ, Tl::Q_BYTES / 16, i, kScalers, s2);
      fence_proxy_async();
      mbar_arrive(&bar.q_ready);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        mbar_wait(&bar.kv_full[s], (j / S) & 1);
        scale_tile(stage_k(s), Tl::KV_BYTES / 16, i, kScalers, s2);
        fence_proxy_async();
        mbar_arrive(&bar.kv_ready[s]);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32;
    const int lane = t & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const bf16* sq = sQ + cw * 64 * AW;  // this warpgroup's rows of every chunk
    // turns: consumer cw issues after the other has (named barriers 1, 2)
    const int my_turn = 1 + cw, other_turn = 2 - cw;

    float o[DP / 2];
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

    // the softmax of tile j on sc in place: new running max, rescale factor
    // alpha for o, p = exp(s - m), l = l * alpha + rowsum(p); then P packed
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int k0 = j * BK;
      if (k0 + BK > p.T) {  // ragged tail: keys past T never win
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (k0 + (i / 4) * 8 + tq * 2 + (i & 1) >= p.T) sc[i] = -INFINITY;
      }
      // both rows at once, each reduced in kP independent chains: the
      // consumers are latency-bound here (two warps a scheduler), and one
      // chain of BK / 4 dependent max or add steps a row would idle them
      constexpr int kP = 4;
      float mx[2][kP], rs[2][kP], mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < kP; ++c) {
          mx[r][c] = -INFINITY;
          rs[r][c] = 0.f;
        }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mx[r][n % kP] = fmaxf(mx[r][n % kP], fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float mn = fmaxf(m[r], v);
        alpha[r] = ex2((m[r] - mn) * kLog2e);  // 0 on the first tile
        m[r] = mn;
        mb[r] = mn * kLog2e;
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x0 = sc[4 * n + 2 * r];
          float& x1 = sc[4 * n + 2 * r + 1];
          x0 = ex2(fmaf(x0, kLog2e, -mb[r]));
          x1 = ex2(fmaf(x1, kLog2e, -mb[r]));
          rs[r][n % kP] += x0 + x1;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = (rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        l[r] = l[r] * alpha[r] + v;
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        pa[kc][0] = pack_bf16(sc[8 * kc + 0], sc[8 * kc + 1]);
        pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
        pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
        pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
      }
    };

    mbar_wait(&bar.q_ready, 0);
    if (cw == 1) named_arrive(other_turn, 256);  // consumer 0 goes first

    // tile 0: QK^T and its softmax (o is 0, nothing to rescale)
    mbar_wait(&bar.kv_full[0], 0);
    mbar_wait(&bar.kv_ready[0], 0);
    named_sync(my_turn, 256);
    wgmma_fence();
    issue_qk<DP, AW>(sc, sq, stage_k(0));
    wgmma_commit();
    if (cw == 0 || n_tiles > 1) named_arrive(other_turn, 256);
    wgmma_wait<0>();
    reg_fence(sc);
    {
      float alpha[2];
      softmax(0, alpha);
    }
    pack_p();

    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % S, sp = (j - 1) % S;
      mbar_wait(&bar.kv_full[s], (j / S) & 1);
      mbar_wait(&bar.kv_ready[s], (j / S) & 1);
      named_sync(my_turn, 256);
      reg_fence(o);
      reg_fence(pa);
      wgmma_fence();
      issue_qk<DP, AW>(sc, sq, stage_k(s));
      wgmma_commit();
      issue_pv<DP, AW>(o, pa, stage_v(sp));
      wgmma_commit();
      if (cw == 0 || j + 1 < n_tiles) named_arrive(other_turn, 256);
      wgmma_wait<1>();  // QK^T of tile j has landed; PV of tile j-1 may run on
      reg_fence(sc);
      float alpha[2];
      softmax(j, alpha);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      if (lane == 0) mbar_arrive(&bar.kv_empty[sp]);  // tile j-1's K and V are read
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p();
    }

    // PV of the last tile
    reg_fence(o);
    reg_fence(pa);
    wgmma_fence();
    issue_pv<DP, AW>(o, pa, stage_v((n_tiles - 1) % S));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);

    // epilogue: normalise once, write [B, T, H, D]
    bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + cw * 64 + warp * 16 + g + 8 * r;
      if (row >= p.T) continue;
      const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
      bf16* orow = out + (((long long)b * p.T + row) * p.H + h) * p.D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int d = n * 8 + tq * 2;
        if (d < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
      if (p.lse != nullptr && tq == 0)
        p.lse[(long long)bh * p.T + row] = l[r] == 0.f ? kFullyMaskedLse : m[r] + logf(l[r]);
    }
  }
}

template <int DP, int AW>
int launch(const Plane (&pl)[3], const Params& p, int B, cudaStream_t stream) {
  using Tl = Tile<DP, AW>;
  CUtensorMap maps[3];
  for (int j = 0; j < 3; ++j)
    if (!encode_plane(&maps[j], pl[j], B, p.T, p.H, p.D, AW, j == 0 ? kBQ : Tl::BK)) return -2;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_sm90<DP, AW>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + kBQ - 1) / kBQ, B * p.H);
  attn_fwd_sm90<DP, AW><<<grid, kThreads, Tl::SMEM, stream>>>(maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shape, fills the rest of p and launches; -1 for a shape or dtype
// the kernel does not take, -2 when a tensor map cannot be encoded.
int run(const Plane (&pl)[3], void* out, float* lse, int is_f32, int B, int T, int H, int D,
        float scale, int device, void* stream) {
  if (is_f32 || D < 8 || D > 256 || D % 8 != 0 || T < 1 || B < 1 || H < 1 || B * H > 65535)
    return -1;
  for (const Plane& x : pl)
    if (reinterpret_cast<uintptr_t>(x.ptr) % 16 != 0) return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.out = out;
  p.lse = lse;
  p.T = T;
  p.H = H;
  p.D = D;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 48 && kD48Chunks16) return launch<48, 16>(pl, p, B, st);
  switch ((D + 63) / 64) {
    case 1: return launch<64, 64>(pl, p, B, st);
    case 2: return launch<128, 64>(pl, p, B, st);
    case 3: return launch<192, 64>(pl, p, B, st);
    default: return launch<256, 64>(pl, p, B, st);
  }
}

}  // namespace

// Both entries take the arguments of attention_fwd.cu's and return
// cudaGetLastError() after the launch (0 on success), -1 for an argument the
// kernel does not take (float32 among them: that is attention_fwd.cu's FMA
// kernel) and -2 when the driver refuses a tensor map. Pointers are device
// pointers; out is [B, T, H, D] contiguous and lse, when not null, [B*H, T]
// f32. Every plane must have unit stride along D, strides that are multiples
// of 8 elements and a 16-byte-aligned base (the wrappers check).

// q, k and v straight out of the fused projection qkv [B, T, 3C], strided
// along batch and token, channels (q|k|v)-major (new_order) or head-major
extern "C" int eo_qkv_attention_fwd(const void* qkv, void* out, float* lse, int is_f32,
                                    int B, int T, int H, int D, long long stride_b,
                                    long long stride_t, int new_order, float scale,
                                    int device, void* stream) {
  const long long C = (long long)H * D;
  Plane pl[3];
  for (int j = 0; j < 3; ++j) {
    pl[j].ptr = static_cast<const char*>(qkv) + 2 * (new_order ? j * C : j * D);
    pl[j].sb = stride_b;
    pl[j].st = stride_t;
    pl[j].sh = new_order ? D : 3LL * D;
  }
  return run(pl, out, lse, is_f32, B, T, H, D, scale, device, stream);
}

// q, k and v as three [B, T, H, D] tensors or views; strides holds their
// (batch, token, head) strides in elements, q's three first
extern "C" int eo_attention_fwd(const void* q, const void* k, const void* v,
                                const long long* strides, void* out, float* lse, int is_f32,
                                int B, int T, int H, int D, float scale, int device,
                                void* stream) {
  const void* ptrs[3] = {q, k, v};
  Plane pl[3];
  for (int j = 0; j < 3; ++j) {
    pl[j].ptr = ptrs[j];
    pl[j].sb = strides[3 * j];
    pl[j].st = strides[3 * j + 1];
    pl[j].sh = strides[3 * j + 2];
  }
  return run(pl, out, lse, is_f32, B, T, H, D, scale, device, stream);
}
