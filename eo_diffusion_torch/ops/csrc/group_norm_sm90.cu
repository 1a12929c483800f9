// GroupNorm + per-sample affine (FiLM) + optional SiLU for Hopper (sm_90a),
// forward and backward, one launch a direction, bound through ctypes.
//
// Replaces the TPU kernel `_gn_kernel` (eo_diffusion_tpu/ops/group_norm.py:48,
// launched by `_gn_pallas` at :77) and, for the backward, the XLA recompute
// of `_gn_bwd` (:104). The function is that of group_norm.cu, whose three
// launches a direction this file replaces on every model path:
//
//   y  = act((x - mean[n, g]) * rstd[n, g] * gamma[n, c] + beta[n, c])
//   dx = rstd * (gamma * dy_p - sum_{c in g} gamma * dbeta / M
//                - x_hat * sum_{c in g} gamma * dgamma / M)
//   dbeta[n, c] = sum_p dy_p,  dgamma[n, c] = sum_p dy_p * x_hat
//
// over a channels-last x [N, HW, C] in bf16 or f32, g = c / (C / G), M = HW *
// C / G, statistics in f32 (rstd = 1/sqrt(var + eps)), dy_p dy taken back
// through the SiLU, the arithmetic in f32, one rounding of each output.
//
// What bounds it on the H100: bytes. A few f32 operations an element against
// 2 or 4 bytes each way; the least it can move is x read and y written once
// (forward), x and dy read and dx written once (backward).
//
// Design. A sample's statistics need all of the sample before any of its
// output can be written, and a sample at the UNet's level 0 (16 MiB in bf16)
// is spread over the whole card. So the grid is persistent and cooperative
// (every block resident, launched with cudaLaunchCooperativeKernel: a grid
// that cannot be resident is a launch error, never a hang), cut into teams
// of `blocks` blocks; team t takes samples t, t + teams, ... in rounds, and
// block b of a team owns rows [b R, b R + R) of each of them. A round:
//   1. the first `held_rows` rows of the block's chunk arrive in shared
//      memory by 1-D bulk copies (cp.async.bulk, one mbarrier a piece), the
//      rest is read from global memory;
//   2. the block reduces its rows: forward, per-group (mean, M2) from sums
//      about a shift (the channel's first value in the chunk); backward,
//      per-channel sums of dy_p and dy_p * x_hat, and their per-group sums
//      weighted by gamma;
//   3. it publishes them, arrives on the team's counter and waits until all
//      `blocks` have arrived (release / acquire at gpu scope);
//   4. every block combines the team's partials in block order (Chan's
//      formula forward), so all hold the same bits; block 0 writes mean and
//      rstd, and the per-channel dgamma and dbeta are summed by the team's
//      warps, a channel each;
//   5. it writes y (or dx) from the rows held in shared memory and re-reads
//      the rest (from L2 where the planner expects the team's re-read to fit
//      there: those rows are first read as evict-last and then as
//      evict-first, while the held rows' copies and the outputs go as
//      evict-first). As each piece is written out, the next round's piece is
//      loaded into its place.
// A block is up to 512 threads, or 1024 for a forward that re-reads much of
// its chunk (its body fits 64 registers; more loads in flight). A round costs
// a chain of dependent global round trips (the copies, the publication, the
// wait, the combine's loads) beyond its bytes, about 10 us on an H100, so the
// planner trades rounds against rows re-read.
// No atomics touch the results: the same bits every run. The counters end
// every launch at zero (the last block to leave resets them), so no memset
// precedes a launch. The planner (ops/group_norm.py `plan`) picks the team
// size, chunk, held rows and pieces per shape and passes them in; this file
// computes the shared-memory layout from them the same way and refuses a
// plan that does not fit.

#include "wgmma_tile.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using eo_wg::bulk_load_1d;
using eo_wg::fence_barrier_init;
using eo_wg::fence_proxy_async;
using eo_wg::l2_evict_first_policy;
using eo_wg::l2_evict_last_policy;
using eo_wg::ld_global_hint;
using eo_wg::mbar_arrive_expect_tx;
using eo_wg::mbar_init;
using eo_wg::mbar_wait;

constexpr int kMaxThreads = 512;  // the backward's block: at most 128 registers a thread
constexpr int kMaxThreadsFwd = 1024;  // the forward's widest block: at most 64 registers
constexpr int kMaxPieces = 8;
constexpr int kMaxTeams = 1024;  // counters: arrive[kMaxTeams], then depart[kMaxTeams]
constexpr int kMaxSmem = 232448;  // 227 KB a block
constexpr int kMaxPerLane = 5;     // partials a lane loads in a combine: blocks <= 160

// One shape's plan, in the order ops/group_norm.py passes it.
struct Plan {
  int N, HW, C, G;
  int vec;         // channels a thread moves at once (C % vec == 0)
  int rpi;         // rows the block covers at once: C / vec * rpi threads work
  int chunk_rows;  // R: rows of a sample a block owns
  int blocks;      // B: blocks a team = chunks a sample (every chunk non-empty)
  int teams;       // T: samples in flight
  int held_rows;   // H: rows of a chunk held in shared memory (<= R)
  int pieces;      // P: bulk copies (and mbarriers) the held rows come in
  int smem_bytes;  // dynamic shared memory a block
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// slots of the staged channel sums (block_channel_sums): at most 1024 / C
__host__ __device__ inline int stage_slots(int C) {
  const int s = 1024 / C;
  return s < 1 ? 1 : s > 32 ? 32 : s;
}

// bytes of shared memory a block needs: the held rows of each tensor (each
// on a 128-byte boundary), the mbarriers, and the f32 scratch of
// (2 S + 3) C + 2 G floats (the block's channel sums, the staged sums of S
// slots, the shifts, the group constants)
__host__ __device__ inline int held_bytes(const Plan& L, int esize) {
  return round_up(L.held_rows * L.C * esize, 128);
}
__host__ __device__ inline int smem_need(const Plan& L, int esize, int tensors) {
  return tensors * held_bytes(L, esize) + 8 * kMaxPieces +
         4 * ((2 * stage_slots(L.C) + 3) * L.C + 2 * L.G);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

// VEC values as one load or store; through a generic pointer, so the same
// code reads shared memory (the held rows) and global memory (the rest)
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

// from global memory under an L2 policy: the rows a block does not hold are
// read first as evict-last (they are read again after the barrier) and then
// as evict-first
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p, uint64_t policy) {
  Vec<T, VEC> v;
  v.raw = ld_global_hint(reinterpret_cast<const typename Vec<T, VEC>::Raw*>(p), policy);
  return v;
}

// VEC f32 values rounded to T and stored as one store (bf16 pairs packed by
// one conversion each)
template <typename T, int VEC>
__device__ __forceinline__ void store_f(T* p, const float* f) {
  Vec<T, VEC> o;
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o.raw);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) o2[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = from_f<T>(f[i]);
  }
  __stcs(reinterpret_cast<typename Vec<T, VEC>::Raw*>(p), o.raw);  // evict-first: read by the next layer, not by this one
}

// the logistic function from the fast exponential and reciprocal (a few ulp
// of f32: far inside the f32 and bf16 limits the kernel is held to)
__device__ __forceinline__ float sigmoid(float y) { return __fdividef(1.f, 1.f + __expf(-y)); }

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

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the block's writes (ordered before by a bar.sync) before the arrival
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Where a block stands: its team, its chunk of rows [r0, r1) of a sample, of
// which [r0, h1) are held in shared memory, and its thread's channels.
struct Chunk {
  int team, b, r0, r1, h1, prow, col, slot;
  bool active;  // the block's thread count is rounded up to whole warps
  __device__ Chunk(const Plan& L) {
    team = blockIdx.x / L.blocks;
    b = blockIdx.x % L.blocks;
    r0 = b * L.chunk_rows;
    r1 = min(r0 + L.chunk_rows, L.HW);
    h1 = min(r0 + L.held_rows, r1);
    prow = L.pieces > 0 ? (L.held_rows + L.pieces - 1) / L.pieces : 0;
    const int vecs = L.C / L.vec;
    active = static_cast<int>(threadIdx.x) < vecs * L.rpi;
    col = threadIdx.x % vecs;
    slot = threadIdx.x / vecs;
  }
  // rows [a, e) of piece p (empty past the held rows)
  __device__ __forceinline__ void piece(int p, int& a, int& e) const {
    a = r0 + p * prow;
    e = min(a + prow, h1);
  }
};

// Thread 0: the bulk copies of piece p of sample s (one or two tensors).
template <typename T>
__device__ __forceinline__ void issue_piece(const Plan& L, const Chunk& k, int p, int s,
                                            const T* src0, T* dst0, const T* src1, T* dst1,
                                            uint64_t* bars) {
  int a, e;
  k.piece(p, a, e);
  if (a >= e) return;
  const uint32_t bytes = static_cast<uint32_t>((e - a) * L.C * sizeof(T));
  const long long off = ((long long)s * L.HW + a) * L.C;
  const int soff = (a - k.r0) * L.C;
  const uint64_t once = l2_evict_first_policy();  // held rows are read from HBM once
  mbar_arrive_expect_tx(&bars[p], src1 ? 2 * bytes : bytes);
  bulk_load_1d(dst0 + soff, src0 + off, bytes, &bars[p], once);
  if (src1) bulk_load_1d(dst1 + soff, src1 + off, bytes, &bars[p], once);
}

// Sum a[VEC], b[VEC] over the block's row slots: on return sm[c] and sm[C + c]
// hold the block's totals for channel c, in a fixed order. Where a warp's
// lanes repeat its channels (32 % vecs == 0) a butterfly first sums them
// (both lanes of a pair add the same two values), then the warps' (or the
// slots') sums pass in stages of S through st[2 S C]; a and b are clobbered.
template <int VEC>
__device__ __forceinline__ void block_channel_sums(const Plan& L, const Chunk& k, float* a,
                                                   float* b, float* sm, float* st) {
  const int C = L.C, vecs = C / VEC, S = stage_slots(C);
  int eslot, nslots;
  bool valid;
  if (32 % vecs == 0) {
    for (int off = 16; off >= vecs; off >>= 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
        b[i] += __shfl_xor_sync(0xffffffffu, b[i], off);
      }
    }
    eslot = threadIdx.x / 32;
    valid = static_cast<int>(threadIdx.x % 32) < vecs;
    nslots = blockDim.x / 32;
  } else {
    eslot = k.slot;
    valid = k.active;
    nslots = L.rpi;
  }
  for (int j0 = 0; j0 < nslots; j0 += S) {
    if (valid && eslot >= j0 && eslot < j0 + S) {
      float* pa = st + (eslot - j0) * C + k.col * VEC;
      float* pb = pa + S * C;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        pa[i] = j0 == 0 ? a[i] : pa[i] + a[i];
        pb[i] = j0 == 0 ? b[i] : pb[i] + b[i];
      }
    }
    __syncthreads();
  }
  const int used = min(S, nslots);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < used; ++j) {
      sa += st[j * C + c];
      sb += st[(S + j) * C + c];
    }
    sm[c] = sa;
    sm[C + c] = sb;
  }
  __syncthreads();
}

// A wait of seconds means a block of the team never ran (a launch that was
// not cooperative): trap, an error the wrapper raises, rather than hang.
__device__ __forceinline__ void team_barrier(int* arrive, int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    red_release_add(arrive, 1);
    for (long long spins = 0; ld_acquire(arrive) < target; ++spins)
      if (spins > (1LL << 28)) __trap();
  }
  __syncthreads();
}

// After its last wait: the last of a team's blocks to leave resets the
// team's counters for the next launch.
__device__ __forceinline__ void team_leave(int* arrive, int* depart, int blocks) {
  if (threadIdx.x == 0 && atomicAdd(depart, 1) == blocks - 1) {
    atomicExch(arrive, 0);
    atomicExch(depart, 0);
  }
}

// a lane's partials j = lane, lane + 32, ... of a team's `blocks` (zero past
// the end), all loads in flight at once
__device__ __forceinline__ void load_partials(const float2* q, int blocks, int lane,
                                              float2 (&v)[kMaxPerLane]) {
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < blocks ? __ldcg(q + j) : make_float2(0.f, 0.f);
  }
}

// sum over lanes in a fixed butterfly; every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int VEC, int MAXT>
__global__ void __launch_bounds__(MAXT)
    gn_sm90_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y, float* __restrict__ mean_out,
                float* __restrict__ rstd_out, int* __restrict__ sync, float2* __restrict__ part,
                Plan L, float eps, int act_silu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Chunk k(L);
  const int C = L.C, G = L.G, cg = C / G;
  T* sx = reinterpret_cast<T*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + held_bytes(L, sizeof(T)));
  float* fs = reinterpret_cast<float*>(bars + kMaxPieces);
  float* st = fs + 2 * C;
  float* shifts = st + 2 * stage_slots(C) * C;
  float* gmean = shifts + C;
  float* grstd = gmean + G;
  int* arrive = sync + k.team;
  int* depart = sync + kMaxTeams + k.team;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const uint64_t keep = l2_evict_last_policy(), drop = l2_evict_first_policy();

  if (threadIdx.x == 0) {
    for (int p = 0; p < L.pieces; ++p) mbar_init(&bars[p], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && k.team < L.N)
    for (int p = 0; p < L.pieces; ++p)
      issue_piece<T>(L, k, p, k.team, x, sx, (const T*)nullptr, (T*)nullptr, bars);

  int round = 0;
  for (int s = k.team; s < L.N; s += L.teams, ++round) {
    const uint32_t par = round & 1;
    const T* xs = x + (long long)s * L.HW * C + k.col * VEC;
    const T* hs = sx - (long long)k.r0 * C + k.col * VEC;  // row r held: hs + r * C
    // 2. the chunk's shifted sums, per channel
    float shift[VEC], s1[VEC], s2[VEC];
    if (k.h1 > k.r0) mbar_wait(&bars[0], par);
    {
      const Vec<T, VEC> v = load<T, VEC>((k.h1 > k.r0 ? hs : xs) + (long long)k.r0 * C);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        shift[i] = to_f(v[i]);
        s1[i] = s2[i] = 0.f;
      }
    }
    auto accumulate = [&](const Vec<T, VEC>& v) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = to_f(v[i]) - shift[i];
        s1[i] += d;
        s2[i] = fmaf(d, d, s2[i]);
      }
    };
    for (int p = 0; p < L.pieces; ++p) {
      int a, e;
      k.piece(p, a, e);
      if (a >= e) break;
      mbar_wait(&bars[p], par);
      if (k.active) {
#pragma unroll 4
        for (int r = a + k.slot; r < e; r += L.rpi)
          accumulate(load<T, VEC>(hs + (long long)r * C));
      }
    }
    if (k.active) {
#pragma unroll 8
      for (int r = k.h1 + k.slot; r < k.r1; r += L.rpi)
        accumulate(load<T, VEC>(xs + (long long)r * C, keep));
      if (k.slot == 0) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) shifts[k.col * VEC + i] = shift[i];
      }
    }
    block_channel_sums<VEC>(L, k, s1, s2, fs, st);
    // the chunk's (mean, M2) per group: channel c has count rows, mean
    // shift + S1 / rows and M2 = S2 - S1^2 / rows; the group's channels have
    // equal counts, so M2_g = sum M2_c + rows * sum (mean_c - mean_g)^2
    const float rows = (float)(k.r1 - k.r0), inv_rows = 1.f / rows;
    float2* pt = part + (long long)(par * L.teams + k.team) * G * L.blocks;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float msum = 0.f;
      for (int j = 0; j < cg; ++j) msum += shifts[g * cg + j] + fs[g * cg + j] * inv_rows;
      const float mg = msum / (float)cg;
      float m2 = 0.f, dev = 0.f;
      for (int j = 0; j < cg; ++j) {
        const int c = g * cg + j;
        const float sa = fs[c];
        const float dm = shifts[c] + sa * inv_rows - mg;
        m2 += fs[C + c] - sa * sa * inv_rows;
        dev = fmaf(dm, dm, dev);
      }
      pt[(long long)g * L.blocks + k.b] = make_float2(mg, fmaxf(m2, 0.f) + rows * dev);
    }
    // the affine of the sample's channels, loaded before the wait
    float ga[VEC], sh[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      ga[i] = gamma[s * C + k.col * VEC + i];
      sh[i] = beta[s * C + k.col * VEC + i];
    }
    // 3. wait for the team
    team_barrier(arrive, L.blocks * (round + 1));
    if (s + L.teams >= L.N) team_leave(arrive, depart, L.blocks);
    // 4. every block combines the sample's chunks in the same order
    for (int g = warp; g < G; g += warps) {
      float cnt = 0.f, m = 0.f, m2 = 0.f;
      float2 q[kMaxPerLane];
      load_partials(pt + (long long)g * L.blocks, L.blocks, lane, q);
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int j = lane + 32 * i;
        if (j < L.blocks) {
          const int jr = min(L.chunk_rows, L.HW - j * L.chunk_rows);
          chan(cnt, m, m2, (float)jr * (float)cg, q[i].x, q[i].y);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float nb = __shfl_xor_sync(0xffffffffu, cnt, off);
        const float mb = __shfl_xor_sync(0xffffffffu, m, off);
        const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
        if (lane & off) {  // both lanes of a pair combine lower lane first
          float n0 = nb, mm = mb, mm2 = m2b;
          chan(n0, mm, mm2, cnt, m, m2);
          cnt = n0, m = mm, m2 = mm2;
        } else {
          chan(cnt, m, m2, nb, mb, m2b);
        }
      }
      if (lane == 0) {
        const float rs = rsqrtf(m2 / cnt + eps);
        gmean[g] = m;
        grstd[g] = rs;
        if (k.b == 0) {
          mean_out[s * G + g] = m;
          rstd_out[s * G + g] = rs;
        }
      }
    }
    __syncthreads();
    // 5. y from the held rows, then from the rest; the next round's pieces
    // follow the written ones into shared memory
    float mu[VEC], sc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = k.col * VEC + i;
      mu[i] = gmean[c / cg];
      sc[i] = grstd[c / cg] * ga[i];
    }
    T* ys = y + (long long)s * L.HW * C + k.col * VEC;
    auto apply = [&](const Vec<T, VEC>& v, long long r) {
      float h[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        h[i] = fmaf(to_f(v[i]) - mu[i], sc[i], sh[i]);
        if (act_silu) h[i] *= sigmoid(h[i]);
      }
      store_f<T, VEC>(ys + r * C, h);
    };
    const int next = s + L.teams;
    for (int p = 0; p < L.pieces; ++p) {
      int a, e;
      k.piece(p, a, e);
      if (a >= e) break;
      if (k.active) {
#pragma unroll 4
        for (int r = a + k.slot; r < e; r += L.rpi) apply(load<T, VEC>(hs + (long long)r * C), r);
      }
      if (next < L.N) {
        __syncthreads();  // every thread is done with piece p
        if (threadIdx.x == 0) {
          fence_proxy_async();
          issue_piece<T>(L, k, p, next, x, sx, (const T*)nullptr, (T*)nullptr, bars);
        }
      }
    }
    if (k.active) {
#pragma unroll 8
      for (int r = k.h1 + k.slot; r < k.r1; r += L.rpi)
        apply(load<T, VEC>(xs + (long long)r * C, drop), r);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    gn_sm90_bwd(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ mean, const float* __restrict__ rstd,
                T* __restrict__ dx, float* __restrict__ dgamma, float* __restrict__ dbeta,
                int* __restrict__ sync, float2* __restrict__ part, Plan L, int act_silu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Chunk k(L);
  const int C = L.C, G = L.G, cg = C / G;
  const int hb = held_bytes(L, sizeof(T));
  T* sx = reinterpret_cast<T*>(smem);
  T* sdy = reinterpret_cast<T*>(smem + hb);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * hb);
  float* fs = reinterpret_cast<float*>(bars + kMaxPieces);
  float* st = fs + 2 * C;
  float* gc1 = st + (2 * stage_slots(C) + 1) * C;
  float* gc2 = gc1 + G;
  int* arrive = sync + k.team;
  int* depart = sync + kMaxTeams + k.team;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const uint64_t keep = l2_evict_last_policy(), drop = l2_evict_first_policy();
  const float inv_m = 1.f / ((float)L.HW * (float)cg);
  // the partials: per group [2][teams][G][blocks], then per channel
  // [2][teams][C][blocks], each (sum of dy_p-ish, sum of dy_p * x_hat-ish)
  float2* part_c = part + 2LL * L.teams * G * L.blocks;

  if (threadIdx.x == 0) {
    for (int p = 0; p < L.pieces; ++p) mbar_init(&bars[p], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && k.team < L.N)
    for (int p = 0; p < L.pieces; ++p) issue_piece<T>(L, k, p, k.team, x, sx, dy, sdy, bars);

  int round = 0;
  for (int s = k.team; s < L.N; s += L.teams, ++round) {
    const uint32_t par = round & 1;
    const long long base = (long long)s * L.HW * C + k.col * VEC;
    const T* xs = x + base;
    const T* gs = dy + base;
    const T* hx = sx - (long long)k.r0 * C + k.col * VEC;
    const T* hg = sdy - (long long)k.r0 * C + k.col * VEC;
    float mu[VEC], rs[VEC], ga[VEC], be[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = k.col * VEC + i;
      mu[i] = mean[s * G + c / cg];
      rs[i] = rstd[s * G + c / cg];
      ga[i] = gamma[s * C + c];
      be[i] = beta[s * C + c];
    }
    // x_hat and dy taken back through the SiLU
    auto eval = [&](int i, float xv, float dyv, float& xh, float& dyp) {
      xh = (xv - mu[i]) * rs[i];
      dyp = dyv;
      if (act_silu) {
        const float yp = fmaf(xh, ga[i], be[i]);
        const float sg = sigmoid(yp);
        dyp = dyv * sg * fmaf(yp, 1.f - sg, 1.f);
      }
    };
    // 2. per-channel sums of dy_p and dy_p * x_hat over the chunk
    float db[VEC], dg[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) db[i] = dg[i] = 0.f;
    auto reduce = [&](const Vec<T, VEC>& xv, const Vec<T, VEC>& gv) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float xh, dyp;
        eval(i, to_f(xv[i]), to_f(gv[i]), xh, dyp);
        db[i] += dyp;
        dg[i] = fmaf(dyp, xh, dg[i]);
      }
    };
    for (int p = 0; p < L.pieces; ++p) {
      int a, e;
      k.piece(p, a, e);
      if (a >= e) break;
      mbar_wait(&bars[p], par);
      if (k.active) {
#pragma unroll 4
        for (int r = a + k.slot; r < e; r += L.rpi)
          reduce(load<T, VEC>(hx + (long long)r * C), load<T, VEC>(hg + (long long)r * C));
      }
    }
    if (k.active) {
#pragma unroll 4
      for (int r = k.h1 + k.slot; r < k.r1; r += L.rpi)
        reduce(load<T, VEC>(xs + (long long)r * C, keep),
               load<T, VEC>(gs + (long long)r * C, keep));
    }
    block_channel_sums<VEC>(L, k, db, dg, fs, st);
    const long long tb = (long long)(par * L.teams + k.team);
    float2* pg_ = part + tb * G * L.blocks;
    float2* pc_ = part_c + tb * C * L.blocks;
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      pc_[(long long)c * L.blocks + k.b] = make_float2(fs[c], fs[C + c]);
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float s1 = 0.f, s2 = 0.f;
      for (int j = 0; j < cg; ++j) {
        const int c = g * cg + j;
        const float w = gamma[s * C + c];
        s1 = fmaf(w, fs[c], s1);
        s2 = fmaf(w, fs[C + c], s2);
      }
      pg_[(long long)g * L.blocks + k.b] = make_float2(s1, s2);
    }
    // 3. wait for the team
    team_barrier(arrive, L.blocks * (round + 1));
    if (s + L.teams >= L.N) team_leave(arrive, depart, L.blocks);
    // 4. the group sums, in every block in the same order; dbeta and dgamma,
    // a channel a warp over the team
    for (int g = warp; g < G; g += warps) {
      float s1 = 0.f, s2 = 0.f;
      float2 v[kMaxPerLane];
      load_partials(pg_ + (long long)g * L.blocks, L.blocks, lane, v);
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        s1 += v[i].x;
        s2 += v[i].y;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        gc1[g] = s1 * inv_m;
        gc2[g] = s2 * inv_m;
      }
    }
    for (int c = k.b * warps + warp; c < C; c += L.blocks * warps) {
      float s1 = 0.f, s2 = 0.f;
      float2 v[kMaxPerLane];
      load_partials(pc_ + (long long)c * L.blocks, L.blocks, lane, v);
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        s1 += v[i].x;
        s2 += v[i].y;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        dbeta[s * C + c] = s1;
        dgamma[s * C + c] = s2;
      }
    }
    __syncthreads();
    // 5. dx from the held rows, then from the rest; the next round's pieces
    // follow into shared memory
    // dx = rstd gamma dy_p - rstd c2 x_hat - rstd c1
    float ka[VEC], kb[VEC], kc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int g = (k.col * VEC + i) / cg;
      ka[i] = rs[i] * ga[i];
      kb[i] = -rs[i] * gc2[g];
      kc[i] = -rs[i] * gc1[g];
    }
    T* ds = dx + base;
    auto write_dx = [&](const Vec<T, VEC>& xv, const Vec<T, VEC>& gv, long long r) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float xh, dyp;
        eval(i, to_f(xv[i]), to_f(gv[i]), xh, dyp);
        o[i] = fmaf(ka[i], dyp, fmaf(kb[i], xh, kc[i]));
      }
      store_f<T, VEC>(ds + r * C, o);
    };
    const int next = s + L.teams;
    for (int p = 0; p < L.pieces; ++p) {
      int a, e;
      k.piece(p, a, e);
      if (a >= e) break;
      if (k.active) {
#pragma unroll 4
        for (int r = a + k.slot; r < e; r += L.rpi)
          write_dx(load<T, VEC>(hx + (long long)r * C), load<T, VEC>(hg + (long long)r * C), r);
      }
      if (next < L.N) {
        __syncthreads();
        if (threadIdx.x == 0) {
          fence_proxy_async();
          issue_piece<T>(L, k, p, next, x, sx, dy, sdy, bars);
        }
      }
    }
    if (k.active) {
#pragma unroll 4
      for (int r = k.h1 + k.slot; r < k.r1; r += L.rpi)
        write_dx(load<T, VEC>(xs + (long long)r * C, drop),
                 load<T, VEC>(gs + (long long)r * C, drop), r);
    }
  }
}

// ---- host ------------------------------------------------------------------

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// 0 if the plan is one the kernels take for this element size and tensor
// count; -1 otherwise
int check_plan(const Plan& L, int esize, int tensors, int max_threads, const void* const* ptrs,
               int nptrs) {
  if (L.N < 1 || L.HW < 1 || L.C < 1 || L.G < 1 || L.C % L.G != 0) return -1;
  if (L.vec < 1 || L.vec * esize > 16 || L.C % L.vec != 0 || L.rpi < 1) return -1;
  if (round_up(L.C / L.vec * L.rpi, 32) > max_threads) return -1;
  if (L.blocks < 1 || L.blocks > 32 * kMaxPerLane || L.teams < 1 || L.teams > kMaxTeams ||
      L.teams > L.N)
    return -1;
  if (L.chunk_rows < 1 || (long long)L.chunk_rows * L.blocks < L.HW ||
      (long long)L.chunk_rows * (L.blocks - 1) >= L.HW)
    return -1;  // every chunk non-empty
  if (L.held_rows < 0 || L.held_rows > L.chunk_rows || L.pieces < 0 || L.pieces > kMaxPieces ||
      (L.held_rows > 0) != (L.pieces > 0) || L.pieces > L.held_rows)
    return -1;
  if (L.held_rows > 0 && (L.C * esize) % 16 != 0) return -1;  // bulk copies of whole rows
  if (L.smem_bytes < smem_need(L, esize, tensors) || L.smem_bytes > kMaxSmem) return -1;
  for (int i = 0; i < nptrs; ++i)
    if (!aligned(ptrs[i], 16)) return -1;
  return 0;
}

// the kernel of a direction, dtype, vector width and block size
template <bool BWD, typename T, int VEC>
const void* kernel_for(int threads) {
  if (BWD) return reinterpret_cast<const void*>(gn_sm90_bwd<T, VEC>);
  return threads > kMaxThreads ? reinterpret_cast<const void*>(gn_sm90_fwd<T, VEC, kMaxThreadsFwd>)
                               : reinterpret_cast<const void*>(gn_sm90_fwd<T, VEC, kMaxThreads>);
}

template <bool BWD, typename T, int VEC>
int launch(const Plan& L, void** args, int device, cudaStream_t st) {
  const int threads = round_up(L.C / L.vec * L.rpi, 32);
  const int wide = threads > kMaxThreads;
  const void* kernel = kernel_for<BWD, T, VEC>(threads);
  // dynamic shared memory above 48 KB is allowed once a kernel and device
  static int allowed[2][64] = {};
  if (device < 0 || device >= 64) return -1;
  if (L.smem_bytes > allowed[wide][device]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[wide][device] = kMaxSmem;
  }
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(L.teams * L.blocks),
                                                    dim3(threads), args,
                                                    static_cast<size_t>(L.smem_bytes), st);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int fwd(const Plan& L, const void* x, const float* gamma, const float* beta, void* y,
        float* mean, float* rstd, void* work, float eps, int act_silu, int device,
        cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  int* sync = static_cast<int*>(work);
  float2* part = reinterpret_cast<float2*>(sync + 2 * kMaxTeams);
  Plan p = L;
  void* args[] = {&xt, &gamma, &beta, &yt, &mean, &rstd, &sync, &part, &p, &eps, &act_silu};
  return launch<false, T, VEC>(L, args, device, st);
}

template <typename T, int VEC>
int bwd(const Plan& L, const void* x, const void* dy, const float* gamma, const float* beta,
        const float* mean, const float* rstd, void* dx, float* dgamma, float* dbeta, void* work,
        int act_silu, int device, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  int* sync = static_cast<int*>(work);
  float2* part = reinterpret_cast<float2*>(sync + 2 * kMaxTeams);
  Plan p = L;
  void* args[] = {&xt,  &dyt,    &gamma, &beta, &mean, &rstd,    &dxt,
                  &dgamma, &dbeta, &sync, &part, &p,    &act_silu};
  return launch<true, T, VEC>(L, args, device, st);
}

Plan read_plan(const int* v) {
  Plan L;
  L.N = v[0], L.HW = v[1], L.C = v[2], L.G = v[3], L.vec = v[4], L.rpi = v[5];
  L.chunk_rows = v[6], L.blocks = v[7], L.teams = v[8], L.held_rows = v[9], L.pieces = v[10];
  L.smem_bytes = v[11];
  return L;
}

// the kernel of a direction, dtype, vector width and block size, as a plain
// pointer (nullptr for a width the kernels do not take)
const void* kernel_of(int is_bwd, int is_f32, int vec, int threads) {
  using bf = __nv_bfloat16;
#define EO_GN_OF(B, T, V) return kernel_for<B, T, V>(threads)
  if (is_bwd) {
    if (is_f32) switch (vec) { case 4: EO_GN_OF(true, float, 4); case 2: EO_GN_OF(true, float, 2); case 1: EO_GN_OF(true, float, 1); }
    else switch (vec) { case 8: EO_GN_OF(true, bf, 8); case 4: EO_GN_OF(true, bf, 4); case 2: EO_GN_OF(true, bf, 2); case 1: EO_GN_OF(true, bf, 1); }
  } else {
    if (is_f32) switch (vec) { case 4: EO_GN_OF(false, float, 4); case 2: EO_GN_OF(false, float, 2); case 1: EO_GN_OF(false, float, 1); }
    else switch (vec) { case 8: EO_GN_OF(false, bf, 8); case 4: EO_GN_OF(false, bf, 4); case 2: EO_GN_OF(false, bf, 2); case 1: EO_GN_OF(false, bf, 1); }
  }
#undef EO_GN_OF
  return nullptr;
}

}  // namespace

// Forward. x, y: [N, HW, C] contiguous, bf16 (is_f32 = 0) or f32, 16-byte
// aligned; gamma, beta: [N, C] f32; mean, rstd: [N, G] f32 outputs; plan: the
// planner's 12 ints; work: the scratch (2 * 1024 ints of counters, zero
// between launches, then 4 * teams * G * blocks floats). Returns 0, the CUDA
// error of the launch (a grid that cannot be resident included), or -1 for a
// plan the kernel does not take.
extern "C" int eo_gn_sm90_fwd(const void* x, const float* gamma, const float* beta, void* y,
                              float* mean, float* rstd, void* work, const int* plan, int is_f32,
                              float eps, int act_silu, int device, void* stream) {
  const Plan L = read_plan(plan);
  const void* ptrs[3] = {x, y, work};
  if (check_plan(L, is_f32 ? 4 : 2, 1, kMaxThreadsFwd, ptrs, 3) != 0) return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EO_GN_FWD(T, V) \
  fwd<T, V>(L, x, gamma, beta, y, mean, rstd, work, eps, act_silu, device, st)
  if (is_f32) {
    switch (L.vec) {
      case 4: return EO_GN_FWD(float, 4);
      case 2: return EO_GN_FWD(float, 2);
      default: return EO_GN_FWD(float, 1);
    }
  }
  switch (L.vec) {
    case 8: return EO_GN_FWD(__nv_bfloat16, 8);
    case 4: return EO_GN_FWD(__nv_bfloat16, 4);
    case 2: return EO_GN_FWD(__nv_bfloat16, 2);
    default: return EO_GN_FWD(__nv_bfloat16, 1);
  }
#undef EO_GN_FWD
}

// Backward. x, dy, dx: [N, HW, C] contiguous in one dtype, 16-byte aligned;
// gamma, beta: [N, C] f32; mean, rstd: [N, G] f32 from the forward; dgamma,
// dbeta: [N, C] f32 outputs; work: 2 * 1024 ints of counters, then
// 4 * teams * blocks * (G + C) floats.
extern "C" int eo_gn_sm90_bwd(const void* x, const void* dy, const float* gamma,
                              const float* beta, const float* mean, const float* rstd, void* dx,
                              float* dgamma, float* dbeta, void* work, const int* plan,
                              int is_f32, int act_silu, int device, void* stream) {
  const Plan L = read_plan(plan);
  const void* ptrs[4] = {x, dy, dx, work};
  if (check_plan(L, is_f32 ? 4 : 2, 2, kMaxThreads, ptrs, 4) != 0) return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EO_GN_BWD(T, V)                                                                    \
  bwd<T, V>(L, x, dy, gamma, beta, mean, rstd, dx, dgamma, dbeta, work, act_silu, device, \
            st)
  if (is_f32) {
    switch (L.vec) {
      case 4: return EO_GN_BWD(float, 4);
      case 2: return EO_GN_BWD(float, 2);
      default: return EO_GN_BWD(float, 1);
    }
  }
  switch (L.vec) {
    case 8: return EO_GN_BWD(__nv_bfloat16, 8);
    case 4: return EO_GN_BWD(__nv_bfloat16, 4);
    case 2: return EO_GN_BWD(__nv_bfloat16, 2);
    default: return EO_GN_BWD(__nv_bfloat16, 1);
  }
#undef EO_GN_BWD
}

// Blocks of `threads` threads and `smem_bytes` of dynamic shared memory that
// one SM holds at once for the kernel of this direction, dtype and vector
// width (the occupancy calculator), or a negative CUDA error.
extern "C" int eo_gn_sm90_blocks_per_sm(int is_bwd, int is_f32, int vec, int threads,
                                        int smem_bytes, int device) {
  const void* k = kernel_of(is_bwd, is_f32, vec, threads);
  if (k == nullptr) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads,
                                                      static_cast<size_t>(smem_bytes));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
