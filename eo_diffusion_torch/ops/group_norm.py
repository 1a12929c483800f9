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
  kernels of ``csrc/group_norm.cu`` (the port of the TPU's K5, ``_gn_pallas``,
  and of its backward ``_gn_bwd``); each counts its launches.
* :class:`GroupNormFn` joins them under autograd: it saves x, gamma, beta and
  the ``[N, G]`` float32 mean and rstd (no output, no float32 copy of x).
* :func:`fused_group_norm` dispatches on the tensor's device: a CUDA tensor
  launches the kernels or raises, a CPU tensor takes the plain versions, and
  only an explicit ``impl="plain"`` runs the plain version on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from eo_diffusion_torch.ops import _build

__all__ = ["group_norm_reference", "group_norm_backward_reference", "group_norm_fwd_cuda",
           "group_norm_bwd_cuda", "GroupNormFn", "fused_group_norm"]

_KERNEL = "group_norm"
_ACTS = ("none", "silu")
# blocks a launch aims for over all samples (about 8 on each of 132 SMs)
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
    """Raise on what the kernels do not take; returns (n, hw, c, chunks_max)
    with x viewed as ``[N, HW, C]``."""
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
    return n, hw, c, min(hw, -(-_TARGET_BLOCKS // n))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fn(name: str, argtypes):
    fn = getattr(_build.load(_KERNEL), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def group_norm_fwd_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        groups: int, eps: float = 1e-5, act: str = "none"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on a CUDA tensor: x ``[N, ..., C]`` bf16 or
    float32, gamma/beta ``[N, C]`` float32. Returns ``(y, mean, rstd)``: y
    like x, mean and rstd ``[N, G]`` float32. Raises on anything the kernel
    does not take and on a failed launch; never falls back."""
    n, hw, c, chunks = _check(x, groups, act, "group_norm_fwd_cuda", gamma=gamma, beta=beta)
    fn = _fn("eo_group_norm_fwd", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                   _I, _I, _P])
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
    group_norm_fwd_cuda.launches += 1
    return y, stats[0], stats[1]


group_norm_fwd_cuda.launches = 0


def group_norm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        mean: torch.Tensor, rstd: torch.Tensor, dy: torch.Tensor,
                        groups: int, act: str = "none"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on CUDA tensors: the forward's x,
    gamma/beta ``[N, C]`` float32 and saved mean/rstd ``[N, G]`` float32, and
    dy like x. Returns ``(dx, dgamma, dbeta)``: dx like x, dgamma and dbeta
    ``[N, C]`` float32. Raises on anything the kernel does not take and on a
    failed launch; never falls back."""
    n, hw, c, chunks = _check(x, groups, act, "group_norm_bwd_cuda", gamma=gamma, beta=beta)
    for name, t, shape, dtype in (("mean", mean, (n, groups), torch.float32),
                                  ("rstd", rstd, (n, groups), torch.float32),
                                  ("dy", dy, tuple(x.shape), x.dtype)):
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape} {dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    fn = _fn("eo_group_norm_bwd", [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _P])
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
    group_norm_bwd_cuda.launches += 1
    return dx, dparams[0], dparams[1]


group_norm_bwd_cuda.launches = 0


class GroupNormFn(torch.autograd.Function):
    """GroupNorm + affine + activation with a kernel on both sides.

    ``forward(x, gamma, beta, groups, eps, act)`` with gamma/beta ``[N, C]``
    float32. On CUDA the kernels, on the CPU the plain versions (so the CPU
    tests run the same plumbing). Saves x, gamma, beta and the float32
    ``[N, G]`` mean and rstd, only when a gradient is needed.
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, groups: int, eps: float, act: str):
        if x.is_cuda:
            y, mean, rstd = group_norm_fwd_cuda(x, gamma, beta, groups, eps, act)
        elif x.device.type == "cpu":
            mean, rstd = _stats(x, groups, eps)
            y = _affine(x, gamma, beta, mean, rstd, groups, act)
        else:
            raise ValueError(f"no group_norm kernel for device {x.device}")
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(x, gamma, beta, mean, rstd)
            ctx.groups, ctx.act = groups, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        bwd = group_norm_bwd_cuda if x.is_cuda else group_norm_backward_reference
        dx, dgamma, dbeta = bwd(x, gamma, beta, mean, rstd, dy.contiguous(), ctx.groups, ctx.act)
        return dx, dgamma, dbeta, None, None, None


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
    return GroupNormFn.apply(x, gamma, beta, groups, eps, act)
