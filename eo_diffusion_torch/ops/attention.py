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
* :func:`reference_attention_bwd` is the plain version of the backward,
  written out with the backward kernel's own recipe (where it rounds to the
  input dtype included); :func:`qkv_attention_bwd_cuda` launches that kernel
  (``csrc/attention_bwd.cu``, the port of the TPU's flash backward K4), which
  writes dq, dk, dv straight into ``dqkv [B, T, 3C]``.
* :class:`QKVAttention` is the ``torch.autograd.Function`` joining the two
  kernels: it saves ``qkv``, ``out`` and the row logsumexp in the forward
  (only when a gradient is needed) and launches the backward kernel, or on
  the CPU the plain backward, in ``backward``.
* :func:`attention_from_qkv` dispatches on the tensor's device: a CUDA
  tensor launches the kernels (or raises), whatever T is; only an explicit
  ``impl="plain"`` runs the plain version on the card, under ordinary
  autograd.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

from eo_diffusion_torch.ops import _build

__all__ = ["reference_attention", "reference_attention_bwd", "split_qkv",
           "stack_qkv", "attention_from_qkv", "qkv_attention_cuda", "qkv_attention_bwd_cuda",
           "QKVAttention"]

_KERNEL = "attention_fwd"
_KERNEL_BWD = "attention_bwd"


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


def reference_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor):
    """Plain attention backward from the saved row logsumexp: ``[B, T, H, D]``
    inputs (``lse`` ``[B*H, T]`` float32) -> ``(dq, dk, dv)`` in the inputs'
    dtypes.

    Step by step the backward kernel's recipe: q*s and k*s round to the input
    dtype; scores, ``p = exp(s - lse)``, ``delta = rowsum(do * o)``, ``dp`` and
    ``ds = p * (dp - delta)`` are float32; p and ds round to the input dtype
    before the three output products, which accumulate in float32 and round
    once (dq and dk after the chain rule's factor s).
    """
    b, t, h, d = q.shape
    sc = _scale(d)
    s_in = torch.tensor(sc, dtype=q.dtype)
    qs, ks = (q * s_in).float(), (k * s_in).float()
    gf = do.float()
    w = torch.einsum("bthd,bshd->bhts", qs, ks)
    p = torch.exp(w - lse.reshape(b, h, t, 1))
    delta = (gf * o.float()).sum(-1).permute(0, 2, 1)[..., None]  # [B, H, T, 1]
    dp = torch.einsum("bthd,bshd->bhts", gf, v.float())
    ds = (p * (dp - delta)).to(q.dtype).float()
    p = p.to(v.dtype).float()
    dv = torch.einsum("bhts,bthd->bshd", p, gf)
    dq = torch.einsum("bhts,bshd->bthd", ds, ks) * sc
    dk = torch.einsum("bhts,bthd->bshd", ds, qs) * sc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def stack_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              new_order: bool = False) -> torch.Tensor:
    """Inverse of :func:`split_qkv`: three ``[B, T, H, D]`` tensors -> the fused
    ``[B, T, 3C]`` layout in the given head order."""
    b, t, h, d = q.shape
    return torch.stack([q, k, v], dim=2 if new_order else 3).reshape(b, t, 3 * h * d)


def _check_qkv(qkv: torch.Tensor, heads: int, who: str):
    """Raise on a projection tensor the kernels do not take; returns (b, t, c, d)."""
    if not qkv.is_cuda:
        raise ValueError(f"{who} needs a CUDA tensor")
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
    return b, t, c, d


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
    b, t, c, d = _check_qkv(qkv, heads, "qkv_attention_cuda")
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


def _kernel_bwd_fn():
    """The backward kernel's C entry point, with its argument types declared."""
    fn = _build.load(_KERNEL_BWD).eo_qkv_attention_bwd
    if fn.argtypes is None:
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i64, i64,
                       i32, f32, f32, i32, ptr]
        fn.restype = ctypes.c_int
    return fn


def qkv_attention_bwd_cuda(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                           dout: torch.Tensor, heads: int,
                           new_order: bool = False) -> torch.Tensor:
    """Launch the flash-attention backward kernel on CUDA tensors.

    ``qkv`` ``[B, T, 3C]`` is the forward's input (bf16 or float32, unit
    channel stride), ``out`` ``[B, T, C]`` and ``lse`` ``[B*H, T]`` float32
    what :func:`qkv_attention_cuda` returned for it, ``dout`` the gradient of
    ``out``. Returns ``dqkv`` ``[B, T, 3C]`` contiguous, in qkv's dtype and
    head order. Raises on anything the kernel does not take and on a failed
    launch; never falls back.
    """
    b, t, c, d = _check_qkv(qkv, heads, "qkv_attention_bwd_cuda")
    for name, x, shape, dtype in (("out", out, (b, t, c), qkv.dtype),
                                  ("dout", dout, (b, t, c), qkv.dtype),
                                  ("lse", lse, (b * heads, t), torch.float32)):
        if x.device != qkv.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {shape} {dtype} on {qkv.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    if out.data_ptr() % 16 or lse.data_ptr() % 4:
        raise ValueError("out needs a 16-byte-aligned base")
    fn = _kernel_bwd_fn()
    dqkv = torch.empty((b, t, 3 * c), dtype=qkv.dtype, device=qkv.device)
    delta = torch.empty((b * heads, t), dtype=torch.float32, device=qkv.device)
    sc = _scale(d)
    rc = fn(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dqkv.data_ptr(), int(qkv.dtype == torch.float32), b, t,
            heads, d, qkv.stride(0), qkv.stride(1), int(new_order),
            float(torch.tensor(sc, dtype=qkv.dtype)), sc, qkv.device.index,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_bwd launch failed: error {rc}")
    qkv_attention_bwd_cuda.launches += 1
    return dqkv


qkv_attention_bwd_cuda.launches = 0


class QKVAttention(torch.autograd.Function):
    """Self-attention from the fused projection with a kernel on both sides.

    Forward: on CUDA :func:`qkv_attention_cuda`, asking for the row
    logsumexp only when qkv needs a gradient (so sampling without autograd
    launches exactly the forward kernel and writes no lse); on the CPU the
    plain version. Backward: on CUDA :func:`qkv_attention_bwd_cuda`, on the
    CPU :func:`reference_attention_bwd` restacked into ``[B, T, 3C]``, so the
    CPU tests run the same plumbing (saved tensors, both head orders).
    """

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int, new_order: bool):
        need = ctx.needs_input_grad[0]
        b, t, c3 = qkv.shape
        if qkv.is_cuda:
            res = qkv_attention_cuda(qkv, heads, new_order, return_lse=need)
            out, lse = res if need else (res, None)
        elif qkv.device.type == "cpu":
            res = reference_attention(*split_qkv(qkv, heads, new_order), return_lse=need)
            out, lse = res if need else (res, None)
            out = out.reshape(b, t, c3 // 3)
        else:
            raise ValueError(f"no attention kernel for device {qkv.device}")
        if need:
            ctx.save_for_backward(qkv, out, lse)
            ctx.heads, ctx.new_order = heads, new_order
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, out, lse = ctx.saved_tensors
        heads, new_order = ctx.heads, ctx.new_order
        if qkv.is_cuda:
            return qkv_attention_bwd_cuda(qkv, out, lse, dout, heads, new_order), None, None
        b, t, c = out.shape
        shape = (b, t, heads, c // heads)
        grads = reference_attention_bwd(*split_qkv(qkv, heads, new_order),
                                        out.reshape(shape), lse, dout.reshape(shape))
        return stack_qkv(*grads, new_order=new_order), None, None


def attention_from_qkv(qkv: torch.Tensor, heads: int, new_order: bool = False,
                       impl: str = "auto", return_lse: bool = False
                       ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention straight from the fused projection: ``[B, T, 3C]`` ->
    ``[B, T, C]`` with channel ``h*D + d``.

    ``impl="auto"`` goes through :class:`QKVAttention`: the CUDA kernels for a
    CUDA tensor (forward and backward), the plain versions for a CPU tensor.
    ``impl="plain"``: the plain version on any device, under ordinary
    autograd. ``return_lse`` also returns the ``[B*H, T]`` row logsumexp and
    is for inspection only: that call carries no gradient on the auto path.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if impl == "auto" and not return_lse:
        return QKVAttention.apply(qkv, heads, new_order)
    if impl == "auto" and qkv.is_cuda:
        return qkv_attention_cuda(qkv, heads, new_order, return_lse)
    if impl == "auto" and qkv.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    b, t, c3 = qkv.shape
    res = reference_attention(*split_qkv(qkv, heads, new_order), return_lse=return_lse)
    if return_lse:
        return res[0].reshape(b, t, c3 // 3), res[1]
    return res.reshape(b, t, c3 // 3)
