// Self-attention backward for Hopper (sm_90a) on wgmma and TMA, bound through
// ctypes. The bf16 body behind both backward entries of the port.
//
// Replaces the same TPU kernels as attention_bwd.cu, which keeps the earlier
// mma.sync body (entries *_mma) and the float32 FMA kernel:
// `_resident_bwd_kernel_tpv` / `_resident_bwd_kernel`
// (eo_diffusion_tpu/ops/attention.py:502 / :429, launched by `_flash_bwd_impl`
// at :569, call :617, and entered through `_qkv5_bwd` at :858 and
// `_flash_bwd` at :669), and for T > 4096 the XLA recompute that `_flash_bwd`
// falls back to. `_flash_bwd_impl` pads D to a multiple of 128, so it takes
// any head dim; this body takes multiples of 8 up to 256. Per batch and
// head, with s = D^-1/4 rounded to bf16:
//
//   qs = q*s, ks = k*s            (rounded to bf16)
//   P  = exp(qs ks^T - lse)       (f32; key columns past T give 0)
//   delta = rowsum(dO * O)        (f32)
//   dS = P * (dO V^T - delta)     (f32)
//   dV = P_b^T dO                 P_b  = P  rounded to bf16
//   dQ = (dS_b ks) * s            dS_b = dS rounded to bf16, s here in f32
//   dK = (dS_b^T qs) * s
//
// accumulated in f32 and rounded once, from the forward's saved [B*H, T]
// natural-log row logsumexp (a fully masked row's +0.7*FLT_MAX gives zero
// gradients). q, k, v and dq, dk, dv are strided planes (entry
// `eo_qkv_attention_bwd`: q, k, v straight out of the projection qkv
// [B, T, 3C] and the gradients straight into dqkv [B, T, 3C], either head
// order; `eo_attention_bwd`: three [B, T, H, D] tensors or views each way);
// O and dO are [B, T, H, D] contiguous.
//
// What bounds it on the H100: five products of 2 T^2 D each a batch and
// head, 10 B H T^2 D operations, against q, k, v, o, do read and dq, dk, dv
// written once: at the clouds UNet's ds-4 training shape (B 8, T 4096, H 8,
// D 48) 515 GFLOP against 200 MB, so the tensor cores bound it (0.52 ms);
// after them the exponentials, one a score in each pass.
//
// Design. Blocks run in no order, so dK and dV cannot accumulate across a
// sequential query axis as on the TPU, and atomics would give other bits on
// every run. So there are two passes (and a small delta kernel before them),
// each block owning what it writes: no atomics, the same bits every run.
// S and dP are computed in both passes: seven products instead of five.
//   * Q pass: a block owns 128 query rows (q*s and dO) and streams K and V
//     tiles of BN keys: S = qs ks^T and dP = dO V^T, dS in registers, then
//     dQ += dS_b ks (wgmma RS: dS packed to bf16 is the A operand, as the
//     forward's P, and the same ks tile is read MN-major).
//   * KV pass: a block owns 128 keys (k*s and V) and streams q and dO tiles
//     of BN queries with their lse and delta: S^T = ks qs^T, dP^T = V dO^T,
//     then dV += P^T_b dO and dK += dS^T_b qs (both RS, B MN-major).
// Every A operand of an output product comes from registers and every B
// from a TMA-loaded swizzled tile, so no score-sized tile goes through
// shared memory and nothing is transposed. Up to D 64 the owned rows are
// register fragments too, read from device memory once (S and dP are RS
// products with B K-major: 2.5-8 % less time on the H100 than from shared
// memory, tools/profile_attn_bwd_sm90.py); above, they are TMA-loaded
// tiles and S and dP are SS products.
//   * Three warpgroups a block, as in attention_fwd_sm90.cu: a producer
//     (warp 0 issues TMA into a ring of up to kMaxStages stages with full,
//     ready and empty mbarriers; warps 1-3 scale the streamed k or q tile by
//     s in shared memory, 16 bytes at a time, the owned one once, and in the
//     KV pass copy the tile's lse (times log2 e; +inf past T, so P = 0 there)
//     and delta beside it) and two consumers of 64 owned rows each, which
//     take turns issuing through two named barriers, so one's exponentials
//     overlap the other's products. Each consumer issues the S and dP
//     products of tile j with the output products of tile j-1.
//   * Head dims are padded to DP, a multiple of 64 (TMA zero-fills the
//     columns past D), except D 48, which runs unpadded as three 16-column
//     chunks swizzled over 32 bytes, as in the forward.
//   * BN, the streamed rows a stage, keeps the accumulators in registers:
//     the Q pass holds S, dP (BN/2 f32 each a thread), dS_b (BN/4) and dQ
//     (DP/2); the KV pass S^T, dP^T, P_b, dS_b, dK and dV. 64 up to D 128,
//     32 above (shared memory holds the two 128-row owned tiles of up to
//     128 KB and at least three stages).
//   * Above D 64 the KV pass's two f32 accumulators (64 x DP each) do not
//     both fit in registers beside S^T and dP^T (at D 256 each takes 128 a
//     thread), so dV and dK are computed in two sweeps over the same query
//     tiles by two sets of blocks (kDV: S^T, P, dV += P_b dO; kDK: S^T,
//     dP^T, dS, dK += dS_b qs): S^T is computed twice there, eight products
//     for seven.
//   * Every pass runs in one grid, blockIdx.z picking it: one launch after
//     delta, and no pass waits for another's last wave (2.5-4.5 % less time
//     than a launch a pass at the UNet's 256 px shapes on the H100, same
//     bits).
//   * delta is its own small kernel before the passes (it reads O and dO
//     once, 2 B T H D bf16 values).
// Not done yet: one pass with an ordered (deterministic) dQ accumulation
// (five products and one exponential a score instead of seven and two),
// TMA stores of the gradients, a persistent schedule.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace eo_wg;

constexpr int kRows = 128;            // owned rows a block: two consumers of 64
constexpr int kThreads = 384;         // producer warpgroup + two consumer warpgroups
constexpr int kScalers = 96;          // producer warps 1-3
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// A block starts with 65536 / 384 = 168 registers a thread, and
// setmaxnreg.inc waits until the registers it asks for are free: what the
// producer gives up must cover what the consumers take, or they wait forever
static_assert(128 * (168 - kProducerRegs) >= 256 * (kConsumerRegs - 168), "register budget");
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;    // a block's opt-in shared memory on the H100
constexpr int kMaxDevices = 16;       // devices whose opt-in is remembered
// D 48 runs unpadded, as three 16-column chunks swizzled over 32 bytes
constexpr bool kD48Chunks16 = true;
constexpr int kMaxStages = 4;         // streamed stages in the ring at most
// keys a stage of the Q pass at D <= 64 (see the top)
constexpr int kQKeys = 64;
// head dims (padded) up to which the KV pass computes dK and dV in one sweep
constexpr int kFusedKV = 64;
// head dims (padded) up to which the owned rows stay in registers as the A
// fragments of the SS products' place (RS, B K-major), in the Q pass and in
// the KV pass: read from device memory once, they never take shared memory
// or its bandwidth
constexpr int kRegAQ = 64;
constexpr int kRegAKV = 64;

// what a launch computes: the Q pass (dQ), the KV pass (dK and dV), or one
// of its two sweeps (dV alone, dK alone)
enum Pass : int { kQ = 0, kKV = 1, kDV = 2, kDK = 3 };

// tiling of a pass for head dims padded to DP, in chunks of AW columns
// swizzled over AW * 2 bytes (wgmma_tile.cuh)
template <int DP, int AW, int PASS>
struct Tile {
  static_assert(DP % AW == 0 && (AW == 64 || DP == 48), "64-column chunks, or D 48 in 16s");
  static constexpr bool KV = PASS != kQ;
  static constexpr bool OUT1 = PASS != kDV;                  // dQ or dK: dS_b B1
  static constexpr bool OUT2 = PASS == kKV || PASS == kDV;   // dV: P_b B2
  static constexpr bool NEED_Y = PASS != kDV;                // dP or dP^T
  static constexpr bool REG_A = DP <= (KV ? kRegAKV : kRegAQ);  // owned rows in registers
  static constexpr int CH = DP / AW;                         // chunks
  static constexpr int ROW = AW * 2;                         // bytes a chunk row
  static constexpr int ATOM = 8 * ROW;                       // bytes of 8 rows: SBO
  static constexpr int BN = DP <= 64 ? (KV ? 64 : kQKeys) : DP <= 128 ? 64 : 32;
  static constexpr int OWN_BYTES = REG_A ? 0 : kRows * DP * 2;  // one owned tile
  static constexpr int TILE_BYTES = BN * DP * 2;             // one streamed tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int VEC_BYTES = KV ? 2 * BN * 4 : 0;      // lse and delta of a stage
  // a stage is held from its load until the RS products of the next tile
  // have read it, so S stages leave about S - 2 tiles of work to hide a load
  static constexpr int FIT = (kSmemLimit - 2 * OWN_BYTES - 2048) / (STAGE_BYTES + VEC_BYTES);
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static_assert(STAGES >= 2, "two stages at least");
  static constexpr int VEC_OFFSET = 2 * OWN_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = VEC_OFFSET + STAGES * VEC_BYTES;
  static constexpr int SMEM = BAR_OFFSET + 1024 + 1024;  // barriers, 1024-byte alignment
  static_assert(SMEM <= kSmemLimit, "shared memory");
};

struct OutPlane {
  bf16* ptr;
  long long sb, st, sh;
};

struct Params {
  Plane q, k, v, dout;  // inputs (dout [B, T, H, D] contiguous)
  OutPlane dq, dk, dv;  // gradients
  const float* lse;     // [B*H, T] f32
  const float* delta;   // [B*H, T] f32
  int T, H, D;
  float scale;      // s, already a bf16 value: q*s and k*s
  float scale_out;  // s in f32: the chain rule's factor on dq and dk
};

// the tensor maps of each pass: its owned planes a1, a2 (unused where the
// owned rows are register fragments) and its streamed planes b1, b2
struct Maps {
  CUtensorMap m[3][4];
};

struct Bars {
  uint64_t own_full, own_ready;
  uint64_t full[kMaxStages], ready[kMaxStages], empty[kMaxStages];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// delta[b*H + h][t] = sum_d dO * O in f32, one thread per (b, t, h)
__global__ void __launch_bounds__(256)
    attn_bwd_delta(const bf16* out, const bf16* dout, float* delta, int B, int T, int H, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * T * H) return;
  const int h = static_cast<int>(i % H);
  const long long bt = i / H;
  const int t = static_cast<int>(bt % T);
  const long long b = bt / T;
  const bf16* o = out + i * D;
  const bf16* g = dout + i * D;
  float acc = 0.f;
  for (int d = 0; d < D; d += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + d);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + d);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 of = __bfloat1622float2(o2[k]);
      const float2 gf = __bfloat1622float2(g2[k]);
      acc = fmaf(gf.x, of.x, acc);
      acc = fmaf(gf.y, of.y, acc);
    }
  }
  delta[(b * H + h) * T + t] = acc;
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma N");
  if constexpr (N == 128)
    wgmma_m64n128k16_ss(d, da, db, accumulate);
  else if constexpr (N == 64)
    wgmma_m64n64k16_ss(d, da, db, accumulate);
  else
    wgmma_m64n32k16_ss(d, da, db, accumulate);
}

// X = A B^T for this warpgroup's 64 owned rows (a: their rows of each chunk
// of the owned tile) and one streamed tile b of BN rows, both K-major
template <int DP, int AW, int PASS>
__device__ __forceinline__ void issue_ss(float (&x)[Tile<DP, AW, PASS>::BN / 2], const bf16* a,
                                         const bf16* b) {
  using Tl = Tile<DP, AW, PASS>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk / (AW / 16), off = (kk % (AW / 16)) * 16;  // chunk, elements into it
    wgmma_ss<Tl::BN>(x, desc_sw<AW>(a + c * kRows * AW + off, 16, Tl::ATOM),
                     desc_sw<AW>(b + c * Tl::BN * AW + off, 16, Tl::ATOM), kk > 0);
  }
}

// X = A B^T as issue_ss, A this warpgroup's owned rows as bf16 fragments
// (af[kk]: k16 slice kk)
template <int DP, int AW, int PASS>
__device__ __forceinline__ void issue_rs_k(float (&x)[Tile<DP, AW, PASS>::BN / 2],
                                           const uint32_t (&af)[DP / 16][4], const bf16* b) {
  using Tl = Tile<DP, AW, PASS>;
  static_assert(Tl::BN == 64, "register A fragments with 64 streamed rows a stage");
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk / (AW / 16), off = (kk % (AW / 16)) * 16;
    wgmma_m64n64k16_rs(x, af[kk], desc_sw<AW>(b + c * Tl::BN * AW + off, 16, Tl::ATOM),
                       kk > 0);
  }
}

// The A fragments (wgmma_tile.cuh) of rows row0 and row0 + 8 of a plane,
// times s2 where `scale` (rounded to bf16 as in scale_tile); zeros past T
// and past D
template <int DP>
__device__ __forceinline__ void load_frags(uint32_t (&af)[DP / 16][4], const Plane& pl, int b,
                                           int h, int row0, int tq, int T, int D, bool scale,
                                           __nv_bfloat162 s2) {
  const bf16* base = static_cast<const bf16*>(pl.ptr) + b * pl.sb + (long long)h * pl.sh;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e & 1);
      const int col = 16 * kk + 2 * tq + 8 * (e >> 1);
      __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
      if (row < T && col < D) {
        v = *reinterpret_cast<const __nv_bfloat162*>(base + (long long)row * pl.st + col);
        if (scale) v = __hmul2(v, s2);
      }
      af[kk][e] = *reinterpret_cast<uint32_t*>(&v);
    }
}

// O += A B for one streamed tile b (BN x DP, read MN-major), A as bf16
// fragments: one m64n64 product per 64-column chunk, or one m64n48 across
// the three 16-column chunks of D 48
template <int DP, int AW, int PASS>
__device__ __forceinline__ void issue_rs(float (&o)[DP / 2],
                                         const uint32_t (&fa)[Tile<DP, AW, PASS>::BN / 16][4],
                                         const bf16* b) {
  using Tl = Tile<DP, AW, PASS>;
#pragma unroll
  for (int kc = 0; kc < Tl::BN / 16; ++kc) {
    if constexpr (AW == 64) {
#pragma unroll
      for (int c = 0; c < Tl::CH; ++c)
        wgmma_m64n64k16_rs_mn(
            o + 32 * c, fa[kc],
            desc_sw<AW>(b + c * Tl::BN * AW + kc * 16 * AW, Tl::BN * Tl::ROW, Tl::ATOM), 1);
    } else {
      wgmma_m64n48k16_rs_mn(o, fa[kc],
                            desc_sw<AW>(b + kc * 16 * AW, Tl::BN * Tl::ROW, Tl::ATOM), 1);
    }
  }
}

// One body for every pass. The block owns the "A side" (128 rows) and
// streams the "B side":
//   Q pass:  A1 = q*s, A2 = dO (rows = queries); B1 = k*s, B2 = v (keys)
//   KV pass: A1 = k*s, A2 = v  (rows = keys);    B1 = q*s, B2 = dO (queries)
// X = A1 B1^T is S or S^T, Y = A2 B2^T is dP or dP^T; lse and delta belong
// to the query (the owned row in the Q pass, the streamed column in the KV
// pass). Then out1 += dS_b B1 (dQ or dK) and out2 += P_b B2 (dV).
template <int DP, int AW, int PASS>
__device__ __forceinline__ void pass_body(const CUtensorMap (&tm)[4], const Params& p,
                                          unsigned char* smem_raw) {
  using Tl = Tile<DP, AW, PASS>;
  constexpr int BN = Tl::BN;
  constexpr int S = Tl::STAGES;
  const CUtensorMap &ta1 = tm[0], &ta2 = tm[1], &tb1 = tm[2], &tb2 = tm[3];
  const Plane& own1 = Tl::KV ? p.k : p.q;
  const Plane& own2 = Tl::KV ? p.v : p.dout;
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sA1 = reinterpret_cast<bf16*>(base);
  bf16* sA2 = reinterpret_cast<bf16*>(base + Tl::OWN_BYTES);
  auto stage_b1 = [&](int s) {
    return reinterpret_cast<bf16*>(base + 2 * Tl::OWN_BYTES + s * Tl::STAGE_BYTES);
  };
  auto stage_b2 = [&](int s) { return stage_b1(s) + BN * DP; };
  // the KV pass's lse * log2(e) and delta of each stage's queries
  auto stage_lse = [&](int s) {
    return reinterpret_cast<float*>(base + Tl::VEC_OFFSET + s * Tl::VEC_BYTES);
  };
  Bars& bar = *reinterpret_cast<Bars*>(base + Tl::BAR_OFFSET);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int r0 = blockIdx.x * kRows;
  const int n_tiles = (p.T + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&bar.own_full, 1);
    mbar_init(&bar.own_ready, kScalers);
    for (int s = 0; s < S; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.ready[s], kScalers);
      mbar_init(&bar.empty[s], 8);  // lane 0 of each consumer warp
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
        if constexpr (!Tl::REG_A) {
          mbar_arrive_expect_tx(&bar.own_full, 2 * Tl::OWN_BYTES);
          for (int c = 0; c < Tl::CH; ++c) {
            tma_load_4d(sA1 + c * kRows * AW, &ta1, &bar.own_full, c * AW, r0, h, b);
            tma_load_4d(sA2 + c * kRows * AW, &ta2, &bar.own_full, c * AW, r0, h, b);
          }
        }
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % S;
          if (j >= S) mbar_wait(&bar.empty[s], ((j / S) - 1) & 1);
          mbar_arrive_expect_tx(&bar.full[s], Tl::STAGE_BYTES);
          for (int c = 0; c < Tl::CH; ++c) {
            tma_load_4d(stage_b1(s) + c * BN * AW, &tb1, &bar.full[s], c * AW, j * BN, h, b);
            tma_load_4d(stage_b2(s) + c * BN * AW, &tb2, &bar.full[s], c * AW, j * BN, h, b);
          }
        }
      }
    } else {
      const int i = threadIdx.x - 32;
      const __nv_bfloat162 s2 = __float2bfloat162_rn(p.scale);
      const float* lse = p.lse + (long long)bh * p.T;
      const float* delta = p.delta + (long long)bh * p.T;
      if constexpr (!Tl::REG_A) {
        mbar_wait(&bar.own_full, 0);
        scale_tile(sA1, Tl::OWN_BYTES / 16, i, kScalers, s2);
        fence_proxy_async();
        mbar_arrive(&bar.own_ready);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        float l2 = INFINITY, dl = 0.f;  // a query past T: P = 0, dS = 0
        if (Tl::KV && i < BN && j * BN + i < p.T) {
          l2 = lse[j * BN + i] * kLog2e;
          dl = delta[j * BN + i];
        }
        mbar_wait(&bar.full[s], (j / S) & 1);
        scale_tile(stage_b1(s), Tl::TILE_BYTES / 16, i, kScalers, s2);
        if (Tl::KV && i < BN) {
          stage_lse(s)[i] = l2;
          stage_lse(s)[BN + i] = dl;
        }
        fence_proxy_async();
        mbar_arrive(&bar.ready[s]);
      }
    }
  } else {
    // ---- consumers: 64 owned rows each ------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32;
    const int lane = t & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const bf16* a1 = sA1 + cw * 64 * AW;  // this warpgroup's rows of every chunk
    const bf16* a2 = sA2 + cw * 64 * AW;
    // turns: consumer cw issues after the other has (named barriers 1, 2)
    const int my_turn = 1 + cw, other_turn = 2 - cw;
    const int row0 = r0 + cw * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

    float x[BN / 2];                      // S or S^T, then P
    float y[Tl::NEED_Y ? BN / 2 : 1];     // dP or dP^T, then dS
    uint32_t pa[Tl::OUT2 ? BN / 16 : 1][4], dsa[Tl::OUT1 ? BN / 16 : 1][4];
    // the owned rows as A fragments (REG_A): a1 * s, a2
    uint32_t a1f[Tl::REG_A ? DP / 16 : 1][4], a2f[Tl::REG_A ? DP / 16 : 1][4];
    if constexpr (Tl::REG_A) {
      const __nv_bfloat162 s2 = __float2bfloat162_rn(p.scale);
      load_frags<DP>(a1f, own1, b, h, row0, tq, p.T, p.D, true, s2);
      load_frags<DP>(a2f, own2, b, h, row0, tq, p.T, p.D, false, s2);
    }
    float o1[Tl::OUT1 ? DP / 2 : 1], o2[Tl::OUT2 ? DP / 2 : 1];
#pragma unroll
    for (int i = 0; i < (Tl::OUT1 ? DP / 2 : 1); ++i) o1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (Tl::OUT2 ? DP / 2 : 1); ++i) o2[i] = 0.f;
    // Q pass: the owned rows' lse (in base 2) and delta; +inf past T (P = 0)
    float row_l2[2] = {INFINITY, INFINITY}, row_dl[2] = {0.f, 0.f};
    if constexpr (!Tl::KV) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < p.T) {
          row_l2[r] = p.lse[(long long)bh * p.T + row] * kLog2e;
          row_dl[r] = p.delta[(long long)bh * p.T + row];
        }
      }
    }

    auto issue_xy = [&](int s) {
      if constexpr (Tl::REG_A) {
        issue_rs_k<DP, AW, PASS>(x, a1f, stage_b1(s));
        if constexpr (Tl::NEED_Y) issue_rs_k<DP, AW, PASS>(y, a2f, stage_b2(s));
      } else {
        issue_ss<DP, AW, PASS>(x, a1, stage_b1(s));
        if constexpr (Tl::NEED_Y) issue_ss<DP, AW, PASS>(y, a2, stage_b2(s));
      }
    };
    auto issue_out = [&](int s) {
      if constexpr (Tl::OUT1) issue_rs<DP, AW, PASS>(o1, dsa, stage_b1(s));
      if constexpr (Tl::OUT2) issue_rs<DP, AW, PASS>(o2, pa, stage_b2(s));
    };
    // P = exp2(X log2e - lse log2e) and dS = P (Y - delta) in place, for
    // tile j in stage s; in the Q pass keys past T give P = 0 (the KV pass's
    // queries past T have lse +inf)
    auto elementwise = [&](int j, int s) {
      if (!Tl::KV && (j + 1) * BN > p.T) {  // ragged last tile: keys past T give P = 0
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          if (j * BN + (i / 4) * 8 + tq * 2 + (i & 1) >= p.T) x[i] = -INFINITY;
      }
      const float* sl = stage_lse(s);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        float2 l2c = make_float2(0.f, 0.f), dlc = l2c;
        if constexpr (Tl::KV) {
          l2c = *reinterpret_cast<const float2*>(sl + 8 * n + 2 * tq);
          if constexpr (Tl::NEED_Y)
            dlc = *reinterpret_cast<const float2*>(sl + BN + 8 * n + 2 * tq);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * n + 2 * r + e;
            const float l2 = Tl::KV ? (e ? l2c.y : l2c.x) : row_l2[r];
            const float dl = Tl::KV ? (e ? dlc.y : dlc.x) : row_dl[r];
            const float pv = ex2(fmaf(x[i], kLog2e, -l2));
            if constexpr (Tl::NEED_Y) y[i] = pv * (y[i] - dl);
            x[i] = pv;
          }
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if constexpr (Tl::OUT2) pa[kc][u] = pack_bf16(x[8 * kc + 2 * u], x[8 * kc + 2 * u + 1]);
          if constexpr (Tl::OUT1) dsa[kc][u] = pack_bf16(y[8 * kc + 2 * u], y[8 * kc + 2 * u + 1]);
        }
    };

    if constexpr (!Tl::REG_A) {
      mbar_wait(&bar.own_full, 0);
      mbar_wait(&bar.own_ready, 0);
    }
    if (cw == 1) named_arrive(other_turn, 256);  // consumer 0 goes first

    // tile 0: X, Y and the elementwise step (nothing to accumulate yet)
    mbar_wait(&bar.full[0], 0);
    mbar_wait(&bar.ready[0], 0);
    named_sync(my_turn, 256);
    reg_fence(a1f);
    reg_fence(a2f);
    wgmma_fence();
    issue_xy(0);
    wgmma_commit();
    if (cw == 0 || n_tiles > 1) named_arrive(other_turn, 256);
    wgmma_wait<0>();
    reg_fence(x);
    reg_fence(y);
    reg_fence(a1f);
    reg_fence(a2f);
    elementwise(0, 0);
    pack();

    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % S, sp = (j - 1) % S;
      mbar_wait(&bar.full[s], (j / S) & 1);
      mbar_wait(&bar.ready[s], (j / S) & 1);
      named_sync(my_turn, 256);
      reg_fence(o1);
      reg_fence(o2);
      reg_fence(pa);
      reg_fence(dsa);
      reg_fence(a1f);
      reg_fence(a2f);
      wgmma_fence();
      issue_xy(s);
      wgmma_commit();
      issue_out(sp);
      wgmma_commit();
      if (cw == 0 || j + 1 < n_tiles) named_arrive(other_turn, 256);
      wgmma_wait<1>();  // X and Y of tile j have landed; the products of j-1 may run on
      reg_fence(x);
      reg_fence(y);
      elementwise(j, s);
      wgmma_wait<0>();
      reg_fence(o1);
      reg_fence(o2);
      reg_fence(pa);
      reg_fence(dsa);
      reg_fence(a1f);
      reg_fence(a2f);
      if (lane == 0) mbar_arrive(&bar.empty[sp]);  // tile j-1 is read
      pack();
    }

    // the output products of the last tile
    reg_fence(o1);
    reg_fence(o2);
    reg_fence(pa);
    reg_fence(dsa);
    wgmma_fence();
    issue_out((n_tiles - 1) % S);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o1);
    reg_fence(o2);

    // epilogue: round once, write dq (Q pass), dk and dv (KV pass)
    const OutPlane& p1 = Tl::KV ? p.dk : p.dq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.T) continue;
      bf16* d1 = p1.ptr + b * p1.sb + (long long)row * p1.st + (long long)h * p1.sh;
      bf16* d2 = p.dv.ptr + b * p.dv.sb + (long long)row * p.dv.st + (long long)h * p.dv.sh;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int d = n * 8 + tq * 2;
        if (d >= p.D) continue;
        if constexpr (Tl::OUT1)
          *reinterpret_cast<__nv_bfloat162*>(d1 + d) = __floats2bfloat162_rn(
              o1[4 * n + 2 * r] * p.scale_out, o1[4 * n + 2 * r + 1] * p.scale_out);
        if constexpr (Tl::OUT2)
          *reinterpret_cast<__nv_bfloat162*>(d2 + d) =
              __floats2bfloat162_rn(o2[4 * n + 2 * r], o2[4 * n + 2 * r + 1]);
      }
    }
  }
}

// Every pass of a head dim in one grid, blockIdx.z picking the pass: the Q
// pass, then the KV pass in one sweep (DP <= kFusedKV) or two. One launch,
// and no pass waits for another's last wave.
template <int DP, int AW>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_sm90(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const int pass = blockIdx.z;
  if (pass == 0) {
    pass_body<DP, AW, kQ>(maps.m[0], p, smem_raw);
  } else if constexpr (DP <= kFusedKV) {
    pass_body<DP, AW, kKV>(maps.m[1], p, smem_raw);
  } else if (pass == 1) {
    pass_body<DP, AW, kDV>(maps.m[1], p, smem_raw);
  } else {
    pass_body<DP, AW, kDK>(maps.m[2], p, smem_raw);
  }
}

// a pass's tensor maps: its owned planes in 128-row boxes (none where they
// are register fragments), its streamed ones in boxes of BN rows
template <int DP, int AW, int PASS>
bool encode_pass(CUtensorMap (&m)[4], const Params& p, int B) {
  using Tl = Tile<DP, AW, PASS>;
  const Plane* pl[4] = {Tl::KV ? &p.k : &p.q, Tl::KV ? &p.v : &p.dout,
                        Tl::KV ? &p.q : &p.k, Tl::KV ? &p.dout : &p.v};
  for (int j = Tl::REG_A ? 2 : 0; j < 4; ++j)
    if (!encode_plane(&m[j], *pl[j], B, p.T, p.H, p.D, AW, j < 2 ? kRows : Tl::BN))
      return false;
  return true;
}

template <int DP, int AW>
int launch(const Params& p, int B, int device, cudaStream_t stream) {
  constexpr bool fused = DP <= kFusedKV;
  constexpr int smem_q = Tile<DP, AW, kQ>::SMEM;
  constexpr int smem_kv = fused ? Tile<DP, AW, kKV>::SMEM
                                : (Tile<DP, AW, kDV>::SMEM > Tile<DP, AW, kDK>::SMEM
                                       ? Tile<DP, AW, kDV>::SMEM
                                       : Tile<DP, AW, kDK>::SMEM);
  constexpr int smem = smem_q > smem_kv ? smem_q : smem_kv;
  Maps maps = {};
  bool ok = encode_pass<DP, AW, kQ>(maps.m[0], p, B);
  if constexpr (fused)
    ok = ok && encode_pass<DP, AW, kKV>(maps.m[1], p, B);
  else
    ok = ok && encode_pass<DP, AW, kDV>(maps.m[1], p, B) &&
         encode_pass<DP, AW, kDK>(maps.m[2], p, B);
  if (!ok) return -2;
  // the shared-memory opt-in, once a device (the 64 px shapes are host-bound)
  static bool opted_in[kMaxDevices] = {};
  if (device >= kMaxDevices || !opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_sm90<DP, AW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) opted_in[device] = true;
  }
  const dim3 grid((p.T + kRows - 1) / kRows, B * p.H, fused ? 2 : 3);
  attn_bwd_sm90<DP, AW><<<grid, kThreads, smem, stream>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shape, launches delta and the passes; -1 for a shape or dtype
// the kernel does not take, -2 when a tensor map cannot be encoded.
int run(const Plane (&in)[3], const OutPlane (&grad)[3], const void* out, const void* dout,
        const float* lse, float* delta, int is_f32, int B, int T, int H, int D, float scale_in,
        float scale_out, int device, void* stream) {
  if (is_f32 || D < 8 || D > 256 || D % 8 != 0 || T < 1 || B < 1 || H < 1 || B * H > 65535)
    return -1;
  for (const Plane& x : in)
    if (reinterpret_cast<uintptr_t>(x.ptr) % 16 != 0) return -1;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0 || reinterpret_cast<uintptr_t>(dout) % 16 != 0)
    return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long C = (long long)H * D;
  Params p;
  p.q = in[0];
  p.k = in[1];
  p.v = in[2];
  p.dout = {dout, (long long)T * C, C, D};
  p.dq = grad[0];
  p.dk = grad[1];
  p.dv = grad[2];
  p.lse = lse;
  p.delta = delta;
  p.T = T;
  p.H = H;
  p.D = D;
  p.scale = scale_in;
  p.scale_out = scale_out;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * T * H;
  attn_bwd_delta<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, B, T, H, D);
  if (D == 48 && kD48Chunks16) return launch<48, 16>(p, B, device, st);
  switch ((D + 63) / 64) {
    case 1: return launch<64, 64>(p, B, device, st);
    case 2: return launch<128, 64>(p, B, device, st);
    case 3: return launch<192, 64>(p, B, device, st);
    default: return launch<256, 64>(p, B, device, st);
  }
}

}  // namespace

// Both entries take the arguments of attention_bwd.cu's (*_mma) and return
// cudaGetLastError() after the launches (0 on success), -1 for an argument
// the kernel does not take (float32 among them: that is attention_bwd.cu's
// FMA kernel) and -2 when a tensor map cannot be encoded. Pointers are
// device pointers. q, k, v need unit stride along D, strides that are
// multiples of 8 elements and 16-byte-aligned bases; dq, dk, dv unit stride
// along D and 4-byte alignment; out and dout are [B, T, H, D] contiguous
// with 16-byte-aligned bases; lse and delta [B*H, T] f32 (the wrappers check
// and allocate).

// q, k, v read from the fused projection qkv [B, T, 3C] (strided along batch
// and token, either head order); dq, dk, dv written into dqkv [B, T, 3C],
// contiguous, in the same head order
extern "C" int eo_qkv_attention_bwd(const void* qkv, const void* out, const void* dout,
                                    const float* lse, float* delta, void* dqkv, int is_f32,
                                    int B, int T, int H, int D, long long stride_b,
                                    long long stride_t, int new_order, float scale_in,
                                    float scale_out, int device, void* stream) {
  const long long C = (long long)H * D;
  Plane in[3];
  OutPlane grad[3];
  for (int j = 0; j < 3; ++j) {
    const long long off = new_order ? j * C : j * D;
    const long long sh = new_order ? D : 3LL * D;
    in[j] = {static_cast<const bf16*>(qkv) + off, stride_b, stride_t, sh};
    grad[j] = {static_cast<bf16*>(dqkv) + off, (long long)T * 3 * C, 3 * C, sh};
  }
  return run(in, grad, out, dout, lse, delta, is_f32, B, T, H, D, scale_in, scale_out, device,
             stream);
}

// q, k, v and dq, dk, dv as six [B, T, H, D] tensors or views; strides holds
// their (batch, token, head) strides in elements in that order, 18 values
extern "C" int eo_attention_bwd(const void* q, const void* k, const void* v, void* dq,
                                void* dk, void* dv, const long long* strides, const void* out,
                                const void* dout, const float* lse, float* delta, int is_f32,
                                int B, int T, int H, int D, float scale_in, float scale_out,
                                int device, void* stream) {
  const void* ins[3] = {q, k, v};
  void* outs[3] = {dq, dk, dv};
  Plane in[3];
  OutPlane grad[3];
  for (int j = 0; j < 3; ++j) {
    in[j] = {ins[j], strides[3 * j], strides[3 * j + 1], strides[3 * j + 2]};
    grad[j] = {static_cast<bf16*>(outs[j]), strides[9 + 3 * j], strides[10 + 3 * j],
               strides[11 + 3 * j]};
  }
  return run(in, grad, out, dout, lse, delta, is_f32, B, T, H, D, scale_in, scale_out, device,
             stream);
}
