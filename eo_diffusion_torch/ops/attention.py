"""UNet self-attention: the plain PyTorch version and its Hopper kernel.

Counterpart of ``eo_diffusion_tpu/ops/attention.py``. Numerics follow the
reference's ``QKVAttention[Legacy]`` (``unet_openai.py:456-519``): q and k are
each scaled by ``1/sqrt(sqrt(D))`` in the input dtype, and the softmax runs
in float32.

* :func:`reference_attention` is the plain version (the counterpart of
  ``xla_attention``); CPU tensors always take it.
* :func:`qkv_attention_cuda` launches the hand-written CUDA kernel
  (``csrc/attention_fwd.cu``, the port of the TPU's fused-qkv kernel K1),
  which reads q/k/v straight out of the ``[B, T, 3C]`` projection.
* :func:`attention_from_qkv` dispatches on the tensor's device: a CUDA
  tensor launches the kernel (or raises), whatever T is; only an explicit
  ``impl="plain"`` runs the plain version on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

from eo_diffusion_torch.ops import _build

__all__ = ["reference_attention", "split_qkv", "attention_from_qkv",
           "qkv_attention_cuda"]

_KERNEL = "attention_fwd"


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(math.sqrt(d))


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        return_lse: bool = False):
    """Plain attention, ``[B, T, H, D]`` -> ``[B, T, H, D]`` in q's dtype.

    q and k are scaled by ``D^-1/4`` in their own dtype (so bf16 inputs round
    there, as the kernel does); the products and the softmax then run in
    float32. With ``return_lse`` also returns the row logsumexp of the
    scaled scores as ``[B*H, T]`` float32, the kernel's lse layout.
    """
    b, t, h, d = q.shape
    s = torch.tensor(_scale(d), dtype=q.dtype)
    qs, ks = (q * s).float(), (k * s).float()
    w = torch.einsum("bthd,bshd->bhts", qs, ks)
    o = torch.einsum("bhts,bshd->bthd", torch.softmax(w, dim=-1), v.float())
    o = o.to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(w, dim=-1).reshape(b * h, t)
    return o


def split_qkv(qkv: torch.Tensor, heads: int, new_order: bool = False):
    """Views q, k, v ``[B, T, H, D]`` of the fused projection ``[B, T, 3C]``.

    Legacy order (``QKVAttentionLegacy``) is head-major: channel
    ``h*3D + j*D + d``; the new order (``QKVAttention``) is (q|k|v)-major:
    channel ``j*C + h*D + d``.
    """
    b, t, c3 = qkv.shape
    d = c3 // 3 // heads
    if new_order:
        r = qkv.reshape(b, t, 3, heads, d)
        return r[:, :, 0], r[:, :, 1], r[:, :, 2]
    r = qkv.reshape(b, t, heads, 3, d)
    return r[:, :, :, 0], r[:, :, :, 1], r[:, :, :, 2]


def _kernel_fn():
    """The kernel's C entry point, with its argument types declared (every
    pointer and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = _build.load(_KERNEL).eo_qkv_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def qkv_attention_cuda(qkv: torch.Tensor, heads: int, new_order: bool = False,
                       return_lse: bool = False):
    """Launch the fused-qkv attention kernel on a CUDA tensor.

    ``qkv`` is ``[B, T, 3C]`` bf16 or float32 with unit stride along channels;
    returns ``o`` ``[B, T, C]`` (channel ``h*D + d``) and, with
    ``return_lse``, ``lse`` ``[B*H, T]`` float32. Raises on anything the
    kernel does not take and on a failed launch; never falls back.
    """
    if not qkv.is_cuda:
        raise ValueError("qkv_attention_cuda needs a CUDA tensor")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {qkv.dtype}")
    b, t, c3 = qkv.shape
    if c3 % (3 * heads):
        raise ValueError(f"{c3} channels do not split into q|k|v x {heads} heads")
    c = c3 // 3
    d = c // heads
    if not (8 <= d <= 128 and d % 8 == 0):
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up to 128")
    if (qkv.stride(2) != 1 or qkv.stride(0) % 8 or qkv.stride(1) % 8
            or qkv.data_ptr() % 16):
        raise ValueError("qkv needs unit channel stride, strides that are "
                         "multiples of 8 and a 16-byte-aligned base")
    if b * heads > 65535:
        raise ValueError(f"B*H = {b * heads} exceeds the launch grid")
    fn = _kernel_fn()
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b * heads, t), dtype=torch.float32, device=qkv.device)
           if return_lse else None)
    # q*s and k*s round in the input dtype: hand the kernel s in that dtype
    scale = float(torch.tensor(_scale(d), dtype=qkv.dtype))
    rc = fn(qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None,
            int(qkv.dtype == torch.float32), b, t, heads, d, qkv.stride(0),
            qkv.stride(1), int(new_order), scale, qkv.device.index,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed: error {rc}")
    qkv_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


qkv_attention_cuda.launches = 0


def attention_from_qkv(qkv: torch.Tensor, heads: int, new_order: bool = False,
                       impl: str = "auto", return_lse: bool = False
                       ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention straight from the fused projection: ``[B, T, 3C]`` ->
    ``[B, T, C]`` with channel ``h*D + d``.

    ``impl="auto"``: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor. ``impl="plain"``: the plain version on any device.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if impl == "auto" and qkv.is_cuda:
        return qkv_attention_cuda(qkv, heads, new_order, return_lse)
    if impl == "auto" and qkv.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    b, t, c3 = qkv.shape
    res = reference_attention(*split_qkv(qkv, heads, new_order), return_lse=return_lse)
    if return_lse:
        return res[0].reshape(b, t, c3 // 3), res[1]
    return res.reshape(b, t, c3 // 3)
