"""W8A8 attention core: the plain PyTorch version and its Hopper kernel.

Counterpart of the JAX package's int8 attention probe kernel
(``tools/probe_int8_attn.py``, ``_int8_kernel`` :82 launched by
``core_int8_pallas`` :118). On q, k, v ``[B*H, T, D]`` each ``[T, D]`` cell
is quantised to int8 with one f32 scale per tensor (``max|x| / 127 +
1e-12``), scores ``q_i k_i^T`` are taken in int32 and scaled by ``s_q s_k
D^-1/2``, the softmax runs in f32, p is re-quantised at the exact 127 scale
(``round(p * 127)``) and ``p_i v_i`` in int32 is scaled back by ``s_v / 127
/ l``; the result has the input dtype.

* :func:`int8_attention_reference` is the plain version, step by step in
  f32 torch ops. Its integer products are exact in f32 (``|S| <= 127^2 *
  64`` and ``|p_i v_i| <= 127^2 * 256``, both below 2^24; on the card TF32
  must be off), so it and the kernel part only where ``exp``'s last bit
  moves ``round(p * 127)`` by one step (see :func:`tolerance`).
* :func:`int8_attention_cuda` launches the hand-written CUDA kernel
  (``csrc/int8_attention.cu``) and counts its launches.
* :func:`int8_attention` is the entry: the kernel for CUDA tensors (or a
  raise), the plain version for CPU tensors, or ``impl="plain"`` anywhere.
"""

from __future__ import annotations

import ctypes

import torch

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops.attention import _dense16

__all__ = ["int8_attention_reference", "int8_attention_cuda", "int8_attention", "tolerance"]

_KERNEL = "int8_attention"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]
# the shapes the kernel takes
MAX_T = 256
HEAD_DIMS = (32, 64)


def _div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` rounded once, as the kernel and the JAX package divide. On
    CUDA, PyTorch turns a division by a Python number into a product with its
    reciprocal, which misses the quotient by an ulp at times; a divisor
    tensor on x's device keeps the division."""
    return x / x.new_tensor(127.0)


def _quantise(x: torch.Tensor):
    """Per-cell symmetric int8 values (as f32) and their f32 scales ``[BH, 1, 1]``."""
    s = _div127(x.abs().amax(dim=(1, 2), keepdim=True)) + 1e-12
    return torch.round(x / s), s


def int8_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             return_stats: bool = False):
    """The W8A8 attention core in f32 torch ops: ``[BH, T, D]`` x3 -> ``[BH,
    T, D]`` in q's dtype. ``return_stats`` also returns the row sums ``l``
    ``[BH, T]`` and v's scales ``s_v`` ``[BH]`` (for :func:`tolerance`)."""
    d = q.shape[-1]
    qi, sq = _quantise(q.float())
    ki, sk = _quantise(k.float())
    vi, sv = _quantise(v.float())
    sf = torch.bmm(qi, ki.transpose(1, 2)) * (sq * sk * d ** -0.5)
    p = torch.exp(sf - sf.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = (torch.bmm(torch.round(p * 127.0), vi) * _div127(sv) / l).to(q.dtype)
    if return_stats:
        return o, l[..., 0], sv.reshape(-1)
    return o


def tolerance(plain: torch.Tensor, l: torch.Tensor, s_v: torch.Tensor) -> torch.Tensor:
    """The elementwise bound on ``|other - plain|`` for another exact
    implementation of the same steps (the kernel; the JAX package's Pallas
    kernel): two steps of ``round(p * 127)`` in a row, each moving o by at
    most ``s_v / l`` (one step changes ``p_i v_i`` by ``|v_i| <= 127``), plus
    the output rounding, one ulp of the output dtype (``2^-7`` relative in
    bf16; ``2^-20`` in f32 for the order of l's sum)."""
    ulp = 2.0 ** -7 if plain.dtype == torch.bfloat16 else 2.0 ** -20
    return 2.0 * s_v[:, None, None] / l[..., None] + ulp * plain.float().abs()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise on q, k, v the kernel does not take; returns (bh, t, d)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("int8_attention_cuda needs CUDA tensors")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {q.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B*H, T, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if {k.dtype, v.dtype} != {q.dtype} or {k.device, v.device} != {q.device}:
        raise ValueError("q, k, v must share one dtype and device")
    bh, t, d = q.shape
    if t % 32 or not 32 <= t <= MAX_T:
        raise ValueError(f"T {t}: the int8 kernel holds a whole cell in shared memory and "
                         f"takes multiples of 32 up to {MAX_T}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the int8 kernel takes {HEAD_DIMS}")
    return bh, t, d


def int8_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the W8A8 attention kernel on three CUDA tensors ``[B*H, T, D]``
    (bf16 or f32; T a multiple of 32 up to 256, D 32 or 64; non-contiguous
    inputs are copied). Returns ``o`` ``[B*H, T, D]`` in the input dtype.
    Raises on anything the kernel does not take and on a failed launch;
    never falls back."""
    bh, t, d = _check(q, k, v)
    q, k, v = _dense16(q), _dense16(k), _dense16(v)
    fn = getattr(_build.load(_KERNEL), "eo_int8_attention_fwd")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.float32), bh, t, d, d ** -0.5, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_attention launch failed: error {rc}")
    int8_attention_cuda.launches += 1
    return out


int8_attention_cuda.launches = 0


def int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   impl: str = "auto") -> torch.Tensor:
    """The W8A8 attention core on ``[B*H, T, D]`` tensors. ``impl="auto"``:
    the CUDA kernel for CUDA tensors (or a raise), the plain version for CPU
    tensors; ``impl="plain"``: the plain version on any device."""
    if impl == "plain":
        return int8_attention_reference(q, k, v)
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if q.is_cuda:
        return int8_attention_cuda(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"no int8 attention kernel for device {q.device}")
    return int8_attention_reference(q, k, v)
