"""GroupNorm + per-sample affine (FiLM) + optional SiLU: the plain PyTorch
version and its Hopper kernel, forward and backward.

Counterpart of ``eo_diffusion_tpu/ops/group_norm.py``. x is channels-last
``[N, ..., C]``; gamma and beta are ``[N, C]`` (a per-sample affine) or
``[C]``. Statistics are float32 over each (sample, group) with eps 1e-5, the
normalise, affine and SiLU run in float32, and the result rounds once to
x's dtype. A FiLM scale-shift folds into the affine:
``gamma[n] = w * (1 + scale[n])``, ``beta[n] = b * (1 + scale[n]) + shift[n]``.

With bf16 activations this rounds differently from the UNet's unfused
recipe (GroupNorm rounded to bf16, then FiLM and SiLU in bf16, as the JAX
UNet does): here SiLU runs in f32 and only its output rounds, which is the
TPU kernel's own recipe (``group_norm.py:43-45``, ``:70-73``). The two
differ by about one bf16 ulp.

* :func:`group_norm_reference` is the plain forward (the JAX package's
  ``group_norm_reference``); :func:`group_norm_backward_reference` the plain
  backward, written out with the kernel's formula.
* :func:`group_norm_fwd_cuda` and :func:`group_norm_bwd_cuda` launch the
  one-launch kernels of ``csrc/group_norm_sm90.cu`` (the port of the TPU's
  K5, ``_gn_pallas``, and of its backward ``_gn_bwd``) with the launch
  :func:`plan` picks for the shape (cached per shape, with the card's
  occupancy; the scratch cached per device and stream); each counts its
  launches. Every shape the wrappers take goes there: no route leads to
  the old body.
* :func:`group_norm_fwd_legacy_cuda` and :func:`group_norm_bwd_legacy_cuda`
  launch the old body, ``csrc/group_norm.cu`` (three launches a direction),
  kept as the new one's yardstick; no model path calls them.
* :class:`GroupNormFn` joins them under autograd: it saves x, gamma, beta and
  the ``[N, G]`` float32 mean and rstd (no output, no float32 copy of x). Its
  forward-mode rule (``torch.func.jvp``: MeanFlow's loss) runs the kernel's
  forward and computes the tangent in plain PyTorch from the same saved
  tensors (:func:`group_norm_jvp_reference`).
* :func:`fused_group_norm` dispatches on the tensor's device: a CUDA tensor
  launches the kernels or raises, a CPU tensor takes the plain versions, and
  only an explicit ``impl="plain"`` runs the plain version on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from eo_diffusion_torch.ops import _build

__all__ = ["group_norm_reference", "group_norm_backward_reference", "group_norm_jvp_reference",
           "group_norm_fwd_cuda", "group_norm_bwd_cuda", "group_norm_fwd_legacy_cuda",
           "group_norm_bwd_legacy_cuda", "GNPlan", "plan", "GroupNormFn", "fused_group_norm"]

_KERNEL_SM90 = "group_norm_sm90"
_KERNEL = "group_norm"  # the old body, three launches a direction
_ACTS = ("none", "silu")
# the old body: blocks a launch aims for over all samples
_TARGET_BLOCKS = 1024


def _grouped(t: torch.Tensor, n: int, groups: int) -> torch.Tensor:
    """``[N, ..., C]`` -> float32 ``[N, P, G, C/G]``."""
    return t.float().reshape(n, -1, groups, t.shape[-1] // groups)


def _stats(x: torch.Tensor, groups: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 mean and rstd ``[N, G]`` of each (sample, group)."""
    var, mean = torch.var_mean(_grouped(x, x.shape[0], groups), dim=(1, 3), unbiased=False)
    return mean, torch.rsqrt(var + eps)


def _affine(x, gamma, beta, mean, rstd, groups, act):
    n = x.shape[0]
    xhat = (_grouped(x, n, groups) - mean[:, None, :, None]) * rstd[:, None, :, None]
    y = xhat.reshape(n, -1, x.shape[-1]) * gamma.float()[:, None] + beta.float()[:, None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def group_norm_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         groups: int, eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """Plain GroupNorm + per-sample affine + optional SiLU: x ``[N, ..., C]``,
    gamma/beta ``[N, C]``; float32 throughout, one rounding to x's dtype."""
    return _affine(x, gamma, beta, *_stats(x, groups, eps), groups, act)


def group_norm_backward_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                                  mean: torch.Tensor, rstd: torch.Tensor, dy: torch.Tensor,
                                  groups: int, act: str = "none"
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward from the forward's saved ``[N, G]`` mean and rstd:
    returns ``(dx, dgamma, dbeta)``, dx in x's dtype, dgamma/dbeta float32
    ``[N, C]``. With ``dy_p`` dy taken back through the SiLU (at
    ``y_p = x_hat * gamma + beta``) and M = P * C/G values a group:

    * ``dbeta[n, c] = sum_p dy_p``, ``dgamma[n, c] = sum_p dy_p * x_hat``;
    * ``dx = rstd * (gamma * dy_p - sum_{c in g} gamma * dbeta / M
      - x_hat * sum_{c in g} gamma * dgamma / M)``.
    """
    n, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xhat = (_grouped(x, n, groups) - mean[:, None, :, None]) * rstd[:, None, :, None]
    ga = gamma.float().reshape(n, 1, groups, cg)
    g = _grouped(dy, n, groups)
    if act == "silu":
        yp = xhat * ga + beta.float().reshape(n, 1, groups, cg)
        s = torch.sigmoid(yp)
        g = g * s * (1 + yp * (1 - s))
    dbeta, dgamma = g.sum(1), (g * xhat).sum(1)  # [N, G, C/G]
    m = xhat.shape[1] * cg
    c1 = (ga[:, 0] * dbeta).sum(-1)[:, None, :, None] / m
    c2 = (ga[:, 0] * dgamma).sum(-1)[:, None, :, None] / m
    dx = rstd[:, None, :, None] * (ga * g - c1 - xhat * c2)
    return dx.reshape(x.shape).to(x.dtype), dgamma.reshape(n, c), dbeta.reshape(n, c)


def _check(x: torch.Tensor, groups: int, act: str, who: str, **params: torch.Tensor):
    """Raise on what the kernels do not take; returns (n, hw, c) with x viewed
    as ``[N, HW, C]``."""
    if not x.is_cuda:
        raise ValueError(f"{who} needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {x.dtype}")
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    if x.dim() < 2:
        raise ValueError(f"x needs a batch and a channel axis, got {tuple(x.shape)}")
    n, c = x.shape[0], x.shape[-1]
    if groups < 1 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    for name, t in params.items():
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (n, c):
            raise ValueError(f"{name}: expected ({n}, {c}) float32 on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    hw = x.numel() // max(n * c, 1)
    if hw < 1 or n > 65535:
        raise ValueError(f"x {tuple(x.shape)}: the kernels need N <= 65535 and a non-empty row")
    return n, hw, c


def _check_saved(x, mean, rstd, dy, groups):
    n = x.shape[0]
    for name, t, shape, dtype in (("mean", mean, (n, groups), torch.float32),
                                  ("rstd", rstd, (n, groups), torch.float32),
                                  ("dy", dy, tuple(x.shape), x.dtype)):
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape} {dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fn(kernel: str, name: str, argtypes):
    fn = getattr(_build.load(kernel), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"eo_gn_sm90_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _I, _I, _P],
             "eo_gn_sm90_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
             "eo_gn_sm90_blocks_per_sm": [_I, _I, _I, _I, _I, _I],
             "eo_group_norm_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                                   _I, _P],
             "eo_group_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _P]}


# -- the planner of the one-launch kernels (csrc/group_norm_sm90.cu) ------------

SMEM_PER_SM = 233472     # 228 KB of an SM's 256 KB can be shared memory
SMEM_PER_BLOCK = 232448  # 227 KB a block at most
SMEM_RESERVED = 1024     # the runtime keeps 1 KB of each block's
L2_BYTES = 50 * 2**20
MAX_THREADS = 512        # a block (at most 128 registers a thread)
# the forward's body fits 64 registers, so it can take a block of 1024
# threads: where a chunk re-reads more than a fifth of its rows from global
# memory the extra loads in flight pay (on an H100, -15 % at 512 px level 0),
# where it holds them the longer block synchronisation costs (+10-20 % at
# level 3)
WIDE_THREADS = 1024
WIDE_BELOW = 0.8
MAX_PIECES = 8
MAX_TEAMS = 1024         # the counters the scratch holds
MAX_BLOCKS = 160         # blocks a team: 5 partials a lane in a combine
PIECE_BYTES = 32 * 1024  # a bulk copy (all tensors of a piece) aims for this
# the cost model that ranks plans (microseconds): HBM bytes at what an SM
# draws of the card's rate, a re-read at 0.4 of that cost from L2 and 1.5
# from HBM, and a round's barrier and combine at 10 us
_HBM_RATE = 3.0e12
_L2_WEIGHT = 0.4
_HBM_WEIGHT = 1.5
_ROUND_US = 10.0


@dataclasses.dataclass(frozen=True)
class GNPlan:
    """One shape's launch of ``group_norm_sm90.cu``: teams of ``blocks``
    blocks take a sample each a round; a block owns ``chunk_rows`` rows of it
    and holds the first ``held_rows`` in shared memory (``pieces`` bulk
    copies), re-reading the rest. ``mode``: "resident" (every row held),
    "l2" (the team's re-read fits in L2) or "hbm"."""

    direction: str
    n: int
    hw: int
    c: int
    groups: int
    esize: int
    vec: int
    rpi: int
    threads: int
    chunk_rows: int
    blocks: int
    teams: int
    held_rows: int
    pieces: int
    smem_bytes: int
    scratch_floats: int
    mode: str
    est_us: float

    def ints(self) -> Tuple[int, ...]:
        """The 12 ints the kernel takes, in its ``Plan`` order."""
        return (self.n, self.hw, self.c, self.groups, self.vec, self.rpi, self.chunk_rows,
                self.blocks, self.teams, self.held_rows, self.pieces, self.smem_bytes)

    @property
    def grid(self) -> int:
        return self.teams * self.blocks


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def model_blocks_per_sm(threads: int, smem_bytes: int) -> int:
    """Blocks an H100 SM holds at once: shared memory, threads, and registers
    at the kernels' bounds (128 a thread up to 512 threads, 64 above; the
    card's own count comes from the occupancy calculator)."""
    regs = 128 if threads <= MAX_THREADS else 64
    return min(SMEM_PER_SM // (smem_bytes + SMEM_RESERVED), 2048 // threads,
               65536 // (threads * regs), 32)


def stage_slots(c: int) -> int:
    """Slots of the kernels' staged channel sums (``stage_slots``)."""
    return max(1, min(32, 1024 // c))


def smem_bytes(held_rows: int, c: int, groups: int, esize: int, tensors: int) -> int:
    """Shared memory a block takes (``smem_need`` of the CUDA source): the
    held rows of each tensor on 128-byte boundaries, the mbarriers and
    (2 S + 3) C + 2 G floats of scratch."""
    return (tensors * _round_up(held_rows * c * esize, 128) + 8 * MAX_PIECES
            + 4 * ((2 * stage_slots(c) + 3) * c + 2 * groups))


def plan(direction: str, n: int, hw: int, c: int, groups: int, esize: int, sms: int = 132,
         blocks_per_sm: Optional[Callable[[int, int], int]] = None,
         teams: Optional[int] = None) -> GNPlan:
    """The launch of the one-launch kernels for x ``[n, hw, c]`` of ``esize``
    bytes an element (2: bf16, 4: f32): one block of up to 512 threads an SM
    (1024 for a forward that re-reads more than a fifth of its rows), and
    over every team count the plan the cost model ranks first.
    ``blocks_per_sm(threads, smem)`` is the card's occupancy
    (:func:`model_blocks_per_sm` by default); ``teams`` fixes the team count
    (to measure one plan against another). Raises RuntimeError for a row
    wider than a block takes."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction must be 'fwd' or 'bwd', got {direction!r}")
    occupancy = blocks_per_sm or model_blocks_per_sm
    tensors = 1 if direction == "fwd" else 2
    vec = next(v for v in (8, 4, 2, 1) if v * esize <= 16 and c % v == 0)
    vecs = c // vec
    if _round_up(vecs, 32) > MAX_THREADS:
        raise RuntimeError(f"group_norm: {c} channels make {vecs} vectors a row, wider than a "
                           f"block of {MAX_THREADS} threads")
    rpi = max(1, MAX_THREADS // vecs)
    threads = _round_up(vecs * rpi, 32)
    row = c * esize
    part = groups if direction == "fwd" else groups + c
    data = SMEM_PER_BLOCK - smem_bytes(0, c, groups, esize, tensors)
    hcap = (data // tensors) // 128 * 128 // row if row % 16 == 0 else 0
    slots = min(sms, MAX_BLOCKS)
    best = None
    for t in ([teams] if teams else range(1, min(n, slots, MAX_TEAMS) + 1)):
        blocks = min(slots // t, hw)
        rows = -(-hw // blocks)
        blocks = -(-hw // rows)
        held = min(rows, hcap)
        pieces = 0 if held == 0 else min(MAX_PIECES, held,
                                         max(1, -(-held * row * tensors // PIECE_BYTES)))
        smem = smem_bytes(held, c, groups, esize, tensors)
        if occupancy(threads, smem) < 1:
            continue
        reread = t * blocks * (rows - held) * row * tensors
        in_l2 = reread <= L2_BYTES // 2
        per_block = (rows * row * (tensors + 1)
                     + (rows - held) * row * tensors * (_L2_WEIGHT if in_l2 else _HBM_WEIGHT))
        est = -(-n // t) * (per_block / (_HBM_RATE / sms) * 1e6 + _ROUND_US)
        if best is None or est < best.est_us:
            mode = "resident" if held == rows else "l2" if in_l2 else "hbm"
            best = GNPlan(direction, n, hw, c, groups, esize, vec, rpi, threads, rows, blocks, t,
                          held, pieces, smem, 2 * MAX_TEAMS + 4 * t * blocks * part, mode, est)
    if best is None:
        raise RuntimeError(f"group_norm: no launch of {direction} fits [{n}, {hw}, {c}]")
    if direction == "fwd" and best.held_rows < WIDE_BELOW * best.chunk_rows:
        rpi = max(1, WIDE_THREADS // vecs)
        threads = _round_up(vecs * rpi, 32)
        if occupancy(threads, best.smem_bytes) >= 1:
            best = dataclasses.replace(best, rpi=rpi, threads=threads)
    return best


_plans: Dict[tuple, tuple] = {}
_scratch: Dict[tuple, torch.Tensor] = {}


def _card_plan(direction: str, x: torch.Tensor, n: int, hw: int, c: int, groups: int):
    """The plan of a shape on x's card (cached), with its ints as a ctypes array."""
    dev = x.device.index
    key = (direction, n, hw, c, groups, x.dtype, dev)
    hit = _plans.get(key)
    if hit is None:
        is_f32 = int(x.dtype == torch.float32)
        vec = next(v for v in (8, 4, 2, 1) if v * x.element_size() <= 16 and c % v == 0)
        query = _fn(_KERNEL_SM90, "eo_gn_sm90_blocks_per_sm",
                    _ARGTYPES["eo_gn_sm90_blocks_per_sm"])

        def blocks_per_sm(threads, smem):
            got = query(int(direction == "bwd"), is_f32, vec, threads, smem, dev)
            if got < 0:
                raise RuntimeError(f"group_norm: occupancy query failed: error {-got}")
            return got

        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        p = plan(direction, n, hw, c, groups, x.element_size(), sms, blocks_per_sm)
        hit = _plans[key] = (p, (ctypes.c_int * 12)(*p.ints()))
    return hit


def _work(x: torch.Tensor, floats: int, stream: int) -> torch.Tensor:
    """The scratch of a device and stream (cached, grown as needed): the
    teams' counters, which every launch leaves at zero, then the partials."""
    key = (x.device.index, stream)
    t = _scratch.get(key)
    if t is None or t.numel() < floats:
        t = torch.zeros(max(floats, 2 * (0 if t is None else t.numel())),
                        dtype=torch.float32, device=x.device)
        _scratch[key] = t
    return t


def group_norm_fwd_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        groups: int, eps: float = 1e-5, act: str = "none"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel (``group_norm_sm90.cu``, one launch) on a
    CUDA tensor: x ``[N, ..., C]`` bf16 or float32, gamma/beta ``[N, C]``
    float32. Returns ``(y, mean, rstd)``: y like x, mean and rstd ``[N, G]``
    float32. Raises on anything the kernel does not take and on a failed
    launch (a grid the card cannot hold at once included); never falls back."""
    n, hw, c = _check(x, groups, act, "group_norm_fwd_cuda", gamma=gamma, beta=beta)
    p, ints = _card_plan("fwd", x, n, hw, c, groups)
    fn = _fn(_KERNEL_SM90, "eo_gn_sm90_fwd", _ARGTYPES["eo_gn_sm90_fwd"])
    x, gamma, beta = _aligned(x), gamma.contiguous(), beta.contiguous()
    y = torch.empty_like(x)
    stats = torch.empty((2, n, groups), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    work = _work(x, p.scratch_floats, stream)
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), work.data_ptr(), ints, int(x.dtype == torch.float32), eps,
            int(act == "silu"), x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm forward launch failed: error {rc} "
                           f"(x {tuple(x.shape)}, {groups} groups, grid {p.grid})")
    group_norm_fwd_cuda.launches += 1
    return y, stats[0], stats[1]


group_norm_fwd_cuda.launches = 0


def group_norm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        mean: torch.Tensor, rstd: torch.Tensor, dy: torch.Tensor,
                        groups: int, act: str = "none"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (``group_norm_sm90.cu``, one launch) on CUDA
    tensors: the forward's x, gamma/beta ``[N, C]`` float32 and saved
    mean/rstd ``[N, G]`` float32, and dy like x. Returns ``(dx, dgamma,
    dbeta)``: dx like x, dgamma and dbeta ``[N, C]`` float32. Raises on
    anything the kernel does not take and on a failed launch; never falls
    back."""
    n, hw, c = _check(x, groups, act, "group_norm_bwd_cuda", gamma=gamma, beta=beta)
    _check_saved(x, mean, rstd, dy, groups)
    p, ints = _card_plan("bwd", x, n, hw, c, groups)
    fn = _fn(_KERNEL_SM90, "eo_gn_sm90_bwd", _ARGTYPES["eo_gn_sm90_bwd"])
    x, dy = _aligned(x), _aligned(dy)
    gamma, beta, mean, rstd = (t.contiguous() for t in (gamma, beta, mean, rstd))
    dx = torch.empty_like(x)
    dparams = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    work = _work(x, p.scratch_floats, stream)
    rc = fn(x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), dparams[0].data_ptr(), dparams[1].data_ptr(),
            work.data_ptr(), ints, int(x.dtype == torch.float32), int(act == "silu"),
            x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm backward launch failed: error {rc} "
                           f"(x {tuple(x.shape)}, {groups} groups, grid {p.grid})")
    group_norm_bwd_cuda.launches += 1
    return dx, dparams[0], dparams[1]


group_norm_bwd_cuda.launches = 0


# -- the old body (csrc/group_norm.cu, three launches a direction) ---------------


def group_norm_fwd_legacy_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                               groups: int, eps: float = 1e-5, act: str = "none"
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward of ``csrc/group_norm.cu`` (statistics, finalize, apply):
    the new body's yardstick, on no model path. As
    :func:`group_norm_fwd_cuda`; counts its launches apart."""
    n, hw, c = _check(x, groups, act, "group_norm_fwd_legacy_cuda", gamma=gamma, beta=beta)
    chunks = min(hw, -(-_TARGET_BLOCKS // n))
    fn = _fn(_KERNEL, "eo_group_norm_fwd", _ARGTYPES["eo_group_norm_fwd"])
    x, gamma, beta = _aligned(x), gamma.contiguous(), beta.contiguous()
    y = torch.empty_like(x)
    stats = torch.empty((2, n, groups), dtype=torch.float32, device=x.device)
    work = torch.empty(2 * n * chunks * groups, dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), work.data_ptr(), int(x.dtype == torch.float32), n, hw, c,
            groups, eps, int(act == "silu"), chunks, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"group_norm forward launch failed: error {rc} "
                           f"(x {tuple(x.shape)}, {groups} groups)")
    group_norm_fwd_legacy_cuda.launches += 1
    return y, stats[0], stats[1]


group_norm_fwd_legacy_cuda.launches = 0


def group_norm_bwd_legacy_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                               mean: torch.Tensor, rstd: torch.Tensor, dy: torch.Tensor,
                               groups: int, act: str = "none"
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``csrc/group_norm.cu`` (reduce, finalize, dx): the new
    body's yardstick, on no model path. As :func:`group_norm_bwd_cuda`;
    counts its launches apart."""
    n, hw, c = _check(x, groups, act, "group_norm_bwd_legacy_cuda", gamma=gamma, beta=beta)
    _check_saved(x, mean, rstd, dy, groups)
    chunks = min(hw, -(-_TARGET_BLOCKS // n))
    fn = _fn(_KERNEL, "eo_group_norm_bwd", _ARGTYPES["eo_group_norm_bwd"])
    x, dy = _aligned(x), _aligned(dy)
    gamma, beta, mean, rstd = (t.contiguous() for t in (gamma, beta, mean, rstd))
    dx = torch.empty_like(x)
    dparams = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    work = torch.empty(2 * n * chunks * c, dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), dparams[0].data_ptr(), dparams[1].data_ptr(),
            work.data_ptr(), int(x.dtype == torch.float32), n, hw, c, groups,
            int(act == "silu"), chunks, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"group_norm backward launch failed: error {rc} "
                           f"(x {tuple(x.shape)}, {groups} groups)")
    group_norm_bwd_legacy_cuda.launches += 1
    return dx, dparams[0], dparams[1]


group_norm_bwd_legacy_cuda.launches = 0


def group_norm_jvp_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor, dx: torch.Tensor,
                             dgamma: Optional[torch.Tensor], dbeta: Optional[torch.Tensor],
                             groups: int, act: str = "none") -> torch.Tensor:
    """The forward-mode derivative (the tangent of y) from the forward's saved
    ``[N, G]`` mean and rstd, in float32, rounded once to x's dtype. With
    ``r = rstd``, ``x_hat = (x - mean) * r`` and the means over a (sample,
    group):

    * ``dx_hat = r * (dx - mean_g dx - x_hat * mean_g(x_hat * dx))``;
    * ``dz = dgamma * x_hat + gamma * dx_hat + dbeta`` (gamma / beta ``[N,
      C]``; a None tangent is zero);
    * ``dy = act'(z) * dz``, for SiLU ``sigmoid(z) * (1 + z * (1 -
      sigmoid(z)))`` at ``z = gamma * x_hat + beta``.
    """
    n, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xhat = (_grouped(x, n, groups) - mean[:, None, :, None]) * rstd[:, None, :, None]
    t = _grouped(dx, n, groups)
    m1 = t.mean(dim=(1, 3), keepdim=True)
    m2 = (xhat * t).mean(dim=(1, 3), keepdim=True)
    dxhat = rstd[:, None, :, None] * (t - m1 - xhat * m2)
    ga = gamma.float().reshape(n, 1, groups, cg)
    dz = ga * dxhat
    if dgamma is not None:
        dz = dz + dgamma.float().reshape(n, 1, groups, cg) * xhat
    if dbeta is not None:
        dz = dz + dbeta.float().reshape(n, 1, groups, cg)
    if act == "silu":
        z = xhat * ga + beta.float().reshape(n, 1, groups, cg)
        s = torch.sigmoid(z)
        dz = dz * s * (1 + z * (1 - s))
    return dz.reshape(x.shape).to(x.dtype)


class GroupNormFn(torch.autograd.Function):
    """GroupNorm + affine + activation with a kernel on both sides, and a
    forward-mode rule.

    ``apply(x, gamma, beta, groups, eps, act)`` with gamma/beta ``[N, C]``
    float32 returns ``(y, mean, rstd)``, the statistics ``[N, G]`` float32
    and not differentiable. On CUDA the kernels, on the CPU the plain
    versions (so the CPU tests run the same plumbing). Saves x, gamma, beta,
    mean and rstd: for the backward when a gradient is needed, and for
    :meth:`jvp`, which ``torch.func.jvp`` (MeanFlow's loss) calls after the
    kernel's forward: the tangent is plain PyTorch
    (:func:`group_norm_jvp_reference`) from what the forward saved.
    """

    @staticmethod
    def forward(x, gamma, beta, groups: int, eps: float, act: str):
        if x.is_cuda:
            return group_norm_fwd_cuda(x, gamma, beta, groups, eps, act)
        if x.device.type == "cpu":
            mean, rstd = _stats(x, groups, eps)
            return _affine(x, gamma, beta, mean, rstd, groups, act), mean, rstd
        raise ValueError(f"no group_norm kernel for device {x.device}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, beta, groups, _, act = inputs
        _, mean, rstd = output
        ctx.mark_non_differentiable(mean, rstd)
        ctx.groups, ctx.act = groups, act
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.save_for_forward(x, gamma, beta, mean, rstd)

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        bwd = group_norm_bwd_cuda if x.is_cuda else group_norm_backward_reference
        dx, dgamma, dbeta = bwd(x, gamma, beta, mean, rstd, dy.contiguous(), ctx.groups, ctx.act)
        return dx, dgamma, dbeta, None, None, None

    @staticmethod
    def jvp(ctx, dx, dgamma, dbeta, *_):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        if dx is None:
            dx = torch.zeros_like(x)
        dy = group_norm_jvp_reference(x, gamma, beta, mean, rstd, dx, dgamma, dbeta,
                                      ctx.groups, ctx.act)
        return dy, None, None


def fused_group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     groups: int = 32, eps: float = 1e-5, act: str = "none",
                     impl: str = "auto") -> torch.Tensor:
    """GroupNorm + per-sample affine + optional SiLU: x ``[N, ..., C]``,
    gamma/beta ``[C]`` or ``[N, C]``.

    ``impl="auto"`` goes through :class:`GroupNormFn`: the CUDA kernels for a
    CUDA tensor (forward and backward; a shape they do not take raises), the
    plain versions for a CPU tensor. ``impl="plain"``: the plain version on
    any device, under ordinary autograd.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    n, c = x.shape[0], x.shape[-1]
    gamma, beta = (t.float().expand(n, c) for t in (gamma, beta))
    if impl == "plain":
        return group_norm_reference(x, gamma, beta, groups, eps, act)
    return GroupNormFn.apply(x, gamma, beta, groups, eps, act)[0]
