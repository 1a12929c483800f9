"""UNet self-attention: the plain PyTorch version and its Hopper kernel.

Counterpart of ``eo_diffusion_tpu/ops/attention.py``. Numerics follow the
reference's ``QKVAttention[Legacy]`` (``unet_openai.py:456-519``): q and k are
each scaled by ``1/sqrt(sqrt(D))`` in the input dtype, and the softmax runs
in float32.

* :func:`reference_attention` is the plain version (the counterpart of
  ``xla_attention``); CPU tensors always take it.
* :func:`qkv_attention_cuda` launches the hand-written CUDA kernel (the
  port of the TPU's fused-qkv kernel K1), which reads q/k/v straight out of
  the ``[B, T, 3C]`` projection: bf16 takes the wgmma/TMA body
  (``csrc/attention_fwd_sm90.cu``); float32 goes to
  :func:`qkv_attention_f32_cuda`, the tensor-core kernel of
  ``csrc/attention_f32_sm90.cu`` (every product a three-term TF32 split, so
  float32 accuracy), which counts its own launches (:func:`fwd_route` holds
  the rules). :func:`qkv_attention_mma_cuda` / :func:`flash_attention_mma_cuda`
  launch ``attention_fwd.cu``, which no model path calls: in bf16 the earlier
  mma.sync body, which the attention probes copy and time as their
  yardstick, in float32 the FMA kernel, the new float32 kernel's yardstick.
* :func:`reference_attention_bwd` is the plain version of the backward,
  written out with the backward kernel's own recipe (where it rounds to the
  input dtype included); :func:`qkv_attention_bwd_cuda` launches that kernel
  (the port of the TPU's flash backward K4), which writes dq, dk, dv straight
  into ``dqkv [B, T, 3C]``: bf16 takes the wgmma/TMA body
  (``csrc/attention_bwd_sm90.cu``), float32 goes to
  :func:`qkv_attention_bwd_f32_cuda` (``csrc/attention_f32_sm90.cu``, its
  own counter; :func:`bwd_route` holds the rules).
  :func:`qkv_attention_bwd_mma_cuda` / :func:`flash_attention_bwd_mma_cuda`
  launch ``attention_bwd.cu`` (bf16: the earlier mma.sync body; float32: the
  FMA kernel), which no model path calls: ``chip_smoke.py`` times it beside
  the new bodies.
* :class:`QKVAttention` is the ``torch.autograd.Function`` joining the two
  kernels: it saves ``qkv``, ``out`` and the row logsumexp in the forward
  (only when a gradient is needed) and launches the backward kernel, or on
  the CPU the plain backward, in ``backward``.
* :func:`flash_attention_cuda` / :func:`flash_attention_bwd_cuda` launch the
  same two kernels through their separate-tensor entries: q, k, v as three
  strided ``[B, T, H, D]`` tensors or views. They are the port of the TPU's
  ``flash_attention`` forward (K2, the resident branch, and K3, the
  grid-tiled one) and of K4 behind it (float32 through
  :func:`flash_attention_f32_cuda` / :func:`flash_attention_bwd_f32_cuda`);
  :class:`FlashAttention` joins them, and :func:`flash_attention` /
  :func:`fused_attention` are the entries.
* :func:`wide_attention_cuda` / :func:`wide_attention_bwd_cuda` launch the
  kernels of ``csrc/attention_wide.cu``, which take the head dims above
  those bodies' limits (256 in bf16, 128 in float32) at any T, keys
  streamed (bf16 on the tensor cores), e.g. the single-head middle
  attention of ``inria64`` (D 1024) and ``eurosat64`` (D 512) at every
  image size; :func:`flash_attention_cuda` and
  :func:`flash_attention_bwd_cuda` hand such shapes to them
  (:func:`fwd_route` says ``"wide"``). :func:`wide_attention_resident_cuda`
  / :func:`wide_attention_bwd_resident_cuda` launch the first wide pair
  (``csrc/attention_wide_resident.cu``, T up to 1024), which no model path
  calls: ``chip_smoke.py`` times it beside the new one.
* :func:`identity_attention` (PAG's perturbation, arXiv:2403.17377): inside
  it every :func:`attention_from_qkv` returns v, launching no kernel, and
  :func:`identity_attention_hits` counts the sites it perturbed.
* :func:`attention_from_qkv` keeps the JAX package's routing: shapes its
  fused-qkv kernel takes (:func:`_qkv_kernel_takes`) go through
  :class:`QKVAttention`, the others through :class:`FlashAttention` on the
  :func:`split_qkv` views. A CUDA tensor launches the kernels (or raises),
  whatever T is; only an explicit ``impl="plain"`` runs the plain version
  on the card, under ordinary autograd.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from eo_diffusion_torch.ops import _build

__all__ = ["reference_attention", "reference_attention_bwd", "split_qkv",
           "stack_qkv", "attention_from_qkv", "qkv_attention_cuda", "qkv_attention_bwd_cuda",
           "QKVAttention", "flash_attention_cuda", "flash_attention_bwd_cuda",
           "FlashAttention", "flash_attention", "fused_attention", "fwd_route",
           "bwd_route", "qkv_attention_mma_cuda", "flash_attention_mma_cuda",
           "qkv_attention_bwd_mma_cuda", "flash_attention_bwd_mma_cuda",
           "wide_attention_cuda", "wide_attention_bwd_cuda", "wide_attention_resident_cuda",
           "wide_attention_bwd_resident_cuda", "qkv_attention_f32_cuda",
           "qkv_attention_bwd_f32_cuda", "flash_attention_f32_cuda",
           "flash_attention_bwd_f32_cuda", "identity_attention", "identity_attention_hits"]

# PAG's perturbed branch (JAX ops/attention.py:61-90): inside
# identity_attention() every self-attention map is the identity, so
# attention_from_qkv returns v; _IDENTITY_HITS counts the sites it perturbed
_IDENTITY = False
_IDENTITY_HITS = 0


def identity_attention_hits() -> int:
    """How many self-attention sites were perturbed inside identity contexts."""
    return _IDENTITY_HITS


@contextlib.contextmanager
def identity_attention():
    """Replace self-attention with the identity map for the calls made
    inside (PAG, arXiv:2403.17377 §3.1: softmax(QK^T) -> I, the output is v).
    Only :func:`attention_from_qkv` is perturbed, so cross-attention paths
    stay as they are, per the paper."""
    global _IDENTITY
    prev, _IDENTITY = _IDENTITY, True
    try:
        yield
    finally:
        _IDENTITY = prev


_KERNEL = "attention_fwd"
_KERNEL_SM90 = "attention_fwd_sm90"
_KERNEL_BWD = "attention_bwd"
_KERNEL_BWD_SM90 = "attention_bwd_sm90"
_KERNEL_WIDE = "attention_wide"
_KERNEL_WIDE_RESIDENT = "attention_wide_resident"
_KERNEL_F32 = "attention_f32_sm90"
# head dims the kernels take: the wgmma bodies (bf16) up to wgmma's N, the
# float32 kernels (tensor-core and FMA) and the mma.sync bodies up to 128
_MAX_D_SM90 = 256
_MAX_D = 128
# the first wide pair holds a CTA's rows of T scores in shared memory: T up
# to this
_RESIDENT_MAX_T = 1024
# the JAX package's fused-qkv kernel takes T up to this (its _MAX_RESIDENT_KV)
_MAX_QKV_T = 4096

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# argument types of the C entry points (every pointer and the stream as
# c_void_p, so none is cut to 32 bits)
_QKV_FWD = [_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _F, _I, _P]
_FLASH_FWD = [_P, _P, _P, _STRIDES, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]
_QKV_BWD = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _F, _F, _I, _P]
_FLASH_BWD = [_P] * 6 + [_STRIDES] + [_P] * 4 + [_I] * 5 + [_F, _F, _I, _P]
_WIDE_BWD = [_P] * 3 + [_STRIDES] + [_P] * 7 + [_I] * 5 + [_F, _F, _I, _P]
_RESIDENT_BWD = [_P] * 3 + [_STRIDES] + [_P] * 8 + [_I] * 5 + [_F, _F, _I, _P]
_ARGTYPES = {
    "eo_qkv_attention_fwd": _QKV_FWD, "eo_qkv_attention_fwd_mma": _QKV_FWD,
    "eo_attention_fwd": _FLASH_FWD, "eo_attention_fwd_mma": _FLASH_FWD,
    "eo_qkv_attention_bwd": _QKV_BWD, "eo_qkv_attention_bwd_mma": _QKV_BWD,
    "eo_attention_bwd": _FLASH_BWD, "eo_attention_bwd_mma": _FLASH_BWD,
    "eo_attention_wide_fwd": _FLASH_FWD, "eo_attention_wide_bwd": _WIDE_BWD,
    "eo_attention_wide_resident_fwd": _FLASH_FWD,
    "eo_attention_wide_resident_bwd": _RESIDENT_BWD,
    "eo_qkv_attention_fwd_tf32x3": _QKV_FWD, "eo_attention_fwd_tf32x3": _FLASH_FWD,
    "eo_qkv_attention_bwd_tf32x3": _QKV_BWD, "eo_attention_bwd_tf32x3": _FLASH_BWD,
    "eo_attention_fwd_tf32x1": _FLASH_FWD, "eo_attention_bwd_tf32x1": _FLASH_BWD,
}


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(math.sqrt(d))


@functools.lru_cache(maxsize=None)
def _scale_in(d: int, dtype: torch.dtype) -> float:
    """``D^-1/4`` rounded to ``dtype``: q*s and k*s round in the input dtype,
    so the kernels are handed s in it (cached: a tensor a launch costs host
    time at short shapes)."""
    return float(torch.tensor(_scale(d), dtype=dtype))


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


def _entry(kernel: str, name: str):
    """A kernel's C entry point, with its argument types declared."""
    fn = getattr(_build.load(kernel), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _route(dtype: torch.dtype, d: int, strides: Sequence[int], ptrs: Sequence[int],
           fused: bool) -> str:
    """What the wgmma/TMA bodies (bf16), the tensor-core float32 kernels and
    the wide kernels accept, for :func:`fwd_route` and :func:`bwd_route`."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {dtype}")
    if d < 8 or d % 8:
        raise ValueError(f"head dim {d}: the kernels take multiples of 8")
    if fused and d > _MAX_D:
        raise ValueError(f"head dim {d} > {_MAX_D}: the fused-qkv entry keeps the JAX "
                         f"package's gate (d <= {_MAX_D})")
    if d > (_MAX_D_SM90 if dtype == torch.bfloat16 else _MAX_D):
        return "wide"  # its wrappers copy q, k, v to 16-byte rows where needed
    if any(st % 8 for st in strides) or any(ptr % 16 for ptr in ptrs):
        raise ValueError("the kernels need strides that are multiples of 8 elements and "
                         "16-byte-aligned bases")
    return "sm90" if dtype == torch.bfloat16 else "tf32x3"


def fwd_route(dtype: torch.dtype, d: int, strides: Sequence[int] = (),
              ptrs: Sequence[int] = (), fused: bool = False) -> str:
    """Which kernel takes a forward launch, from what the kernels accept.

    ``"sm90"``: bf16, the wgmma/TMA body (``csrc/attention_fwd_sm90.cu``), any
    head dim that is a multiple of 8 up to 256 on the separate-tensor entry
    and up to 128 on the fused-qkv one (the JAX package's gate, d <= 128);
    ``"tf32x3"``: float32, the tensor-core kernel of
    ``csrc/attention_f32_sm90.cu`` (three-term TF32 products), up to 128.
    ``strides`` are the element strides and ``ptrs`` the base addresses
    of what the kernel is handed (TMA reads rows of 16 bytes: strides that
    are multiples of 8 elements, 16-byte-aligned bases). ``"wide"``: a head
    dim above those on the separate-tensor entry, at any T, the kernel of
    ``csrc/attention_wide.cu``. Raises ValueError on anything no forward
    kernel takes.
    """
    return _route(dtype, d, strides, ptrs, fused)


def bwd_route(dtype: torch.dtype, d: int, strides: Sequence[int] = (),
              ptrs: Sequence[int] = (), fused: bool = False) -> str:
    """Which kernel takes a backward launch, from what the kernels accept:
    the rules of :func:`fwd_route`. ``"sm90"``: bf16, the wgmma/TMA body
    (``csrc/attention_bwd_sm90.cu``), D up to 256 on the separate-tensor
    entry and 128 on the fused-qkv one; ``"tf32x3"``: float32, the
    tensor-core kernel of ``csrc/attention_f32_sm90.cu``, up to 128;
    ``"wide"``: above those, at any
    T, ``csrc/attention_wide.cu``. ``strides`` and ``ptrs`` are those of q,
    k and v. Raises ValueError on anything no backward kernel takes.
    """
    return _route(dtype, d, strides, ptrs, fused)


def _qkv_fwd(qkv: torch.Tensor, heads: int, new_order: bool, return_lse: bool, kernel: str,
             name: str, dims: Tuple[int, int, int, int]):
    """One launch of a fused-qkv forward entry on a checked ``qkv`` of
    ``dims`` (b, t, c, d); (out, lse or None)."""
    b, t, c, d = dims
    fn = _entry(kernel, name)
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b * heads, t), dtype=torch.float32, device=qkv.device)
           if return_lse else None)
    scale = _scale_in(d, qkv.dtype)
    rc = fn(qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None,
            int(qkv.dtype == torch.float32), b, t, heads, d, qkv.stride(0),
            qkv.stride(1), int(new_order), scale, qkv.device.index,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: error {rc}")
    return out, lse


def qkv_attention_cuda(qkv: torch.Tensor, heads: int, new_order: bool = False,
                       return_lse: bool = False):
    """Launch the fused-qkv attention kernel on a CUDA tensor.

    ``qkv`` is ``[B, T, 3C]`` bf16 or float32 with unit stride along channels;
    returns ``o`` ``[B, T, C]`` (channel ``h*D + d``) and, with
    ``return_lse``, ``lse`` ``[B*H, T]`` float32. bf16 launches the wgmma/TMA
    body (``.launches`` counts it); float32 goes to
    :func:`qkv_attention_f32_cuda`, which counts its own (:func:`fwd_route`).
    Raises on anything the kernel does not take and on a failed launch;
    never falls back.
    """
    dims = _check_qkv(qkv, heads, "qkv_attention_cuda")
    route = fwd_route(qkv.dtype, dims[3], qkv.stride()[:2], (qkv.data_ptr(),), fused=True)
    if route == "tf32x3":
        return qkv_attention_f32_cuda(qkv, heads, new_order, return_lse)
    out, lse = _qkv_fwd(qkv, heads, new_order, return_lse, _KERNEL_SM90,
                        "eo_qkv_attention_fwd", dims)
    qkv_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


qkv_attention_cuda.launches = 0


def qkv_attention_f32_cuda(qkv: torch.Tensor, heads: int, new_order: bool = False,
                           return_lse: bool = False):
    """:func:`qkv_attention_cuda` in float32: the tensor-core kernel of
    ``csrc/attention_f32_sm90.cu``, every product three TF32 products (the
    hi/lo split), so float32 accuracy. ``.launches`` counts its launches.
    Raises on anything it does not take (bf16 included) and on a failed
    launch; never falls back."""
    dims = _check_qkv(qkv, heads, "qkv_attention_f32_cuda")
    if qkv.dtype != torch.float32:
        raise ValueError(f"qkv_attention_f32_cuda takes float32, got {qkv.dtype}")
    out, lse = _qkv_fwd(qkv, heads, new_order, return_lse, _KERNEL_F32,
                        "eo_qkv_attention_fwd_tf32x3", dims)
    qkv_attention_f32_cuda.launches += 1
    return (out, lse) if return_lse else out


qkv_attention_f32_cuda.launches = 0


def qkv_attention_mma_cuda(qkv: torch.Tensor, heads: int, new_order: bool = False,
                           return_lse: bool = False):
    """:func:`qkv_attention_cuda` through ``attention_fwd.cu``: in bf16 the
    earlier mma.sync body, which the attention probes copy, kept as their
    yardstick; in float32 the FMA kernel, the yardstick of
    :func:`qkv_attention_f32_cuda`. No model path calls it; ``.launches``
    counts its launches."""
    dims = _check_qkv(qkv, heads, "qkv_attention_mma_cuda")
    out, lse = _qkv_fwd(qkv, heads, new_order, return_lse, _KERNEL,
                        "eo_qkv_attention_fwd_mma", dims)
    qkv_attention_mma_cuda.launches += 1
    return (out, lse) if return_lse else out


qkv_attention_mma_cuda.launches = 0


def _qkv_bwd(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
             heads: int, new_order: bool, kernel: str, name: str,
             dims: Tuple[int, int, int, int]) -> torch.Tensor:
    """One launch of a fused-qkv backward entry on a checked ``qkv`` of
    ``dims`` (b, t, c, d); returns ``dqkv``."""
    b, t, c, d = dims
    for label, x, shape, dtype in (("out", out, (b, t, c), qkv.dtype),
                                   ("dout", dout, (b, t, c), qkv.dtype),
                                   ("lse", lse, (b * heads, t), torch.float32)):
        if x.device != qkv.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{label}: expected {shape} {dtype} on {qkv.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    out, dout, lse = _dense16(out), _dense16(dout), _dense16(lse)
    fn = _entry(kernel, name)
    dqkv = torch.empty((b, t, 3 * c), dtype=qkv.dtype, device=qkv.device)
    delta = torch.empty((b * heads, t), dtype=torch.float32, device=qkv.device)
    sc = _scale(d)
    rc = fn(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dqkv.data_ptr(), int(qkv.dtype == torch.float32), b, t,
            heads, d, qkv.stride(0), qkv.stride(1), int(new_order),
            _scale_in(d, qkv.dtype), sc, qkv.device.index,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: error {rc}")
    return dqkv


def qkv_attention_bwd_cuda(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                           dout: torch.Tensor, heads: int,
                           new_order: bool = False) -> torch.Tensor:
    """Launch the flash-attention backward kernel on CUDA tensors.

    ``qkv`` ``[B, T, 3C]`` is the forward's input (bf16 or float32, unit
    channel stride), ``out`` ``[B, T, C]`` and ``lse`` ``[B*H, T]`` float32
    what :func:`qkv_attention_cuda` returned for it, ``dout`` the gradient of
    ``out``. Returns ``dqkv`` ``[B, T, 3C]`` contiguous, in qkv's dtype and
    head order. bf16 launches the wgmma/TMA body (``.launches`` counts it);
    float32 goes to :func:`qkv_attention_bwd_f32_cuda`, which counts its own
    (:func:`bwd_route`). Raises on anything the kernel does not take and on a
    failed launch; never falls back.
    """
    dims = _check_qkv(qkv, heads, "qkv_attention_bwd_cuda")
    route = bwd_route(qkv.dtype, dims[3], qkv.stride()[:2], (qkv.data_ptr(),), fused=True)
    if route == "tf32x3":
        return qkv_attention_bwd_f32_cuda(qkv, out, lse, dout, heads, new_order)
    dqkv = _qkv_bwd(qkv, out, lse, dout, heads, new_order, _KERNEL_BWD_SM90,
                    "eo_qkv_attention_bwd", dims)
    qkv_attention_bwd_cuda.launches += 1
    return dqkv


qkv_attention_bwd_cuda.launches = 0


def qkv_attention_bwd_f32_cuda(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                               dout: torch.Tensor, heads: int,
                               new_order: bool = False) -> torch.Tensor:
    """:func:`qkv_attention_bwd_cuda` in float32: the tensor-core backward of
    ``csrc/attention_f32_sm90.cu`` (a delta kernel, then one grid of key and
    query jobs, each CTA owning what it writes: no atomics, the same bits
    every run). ``.launches`` counts its calls. Raises on anything it does
    not take and on a failed launch; never falls back."""
    dims = _check_qkv(qkv, heads, "qkv_attention_bwd_f32_cuda")
    if qkv.dtype != torch.float32:
        raise ValueError(f"qkv_attention_bwd_f32_cuda takes float32, got {qkv.dtype}")
    dqkv = _qkv_bwd(qkv, out, lse, dout, heads, new_order, _KERNEL_F32,
                    "eo_qkv_attention_bwd_tf32x3", dims)
    qkv_attention_bwd_f32_cuda.launches += 1
    return dqkv


qkv_attention_bwd_f32_cuda.launches = 0


def qkv_attention_bwd_mma_cuda(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                               dout: torch.Tensor, heads: int,
                               new_order: bool = False) -> torch.Tensor:
    """:func:`qkv_attention_bwd_cuda` through ``attention_bwd.cu`` (bf16: the
    earlier mma.sync body; float32: the FMA kernel), kept as the new bodies'
    yardstick. No model path calls it; ``.launches`` counts its launches."""
    dims = _check_qkv(qkv, heads, "qkv_attention_bwd_mma_cuda")
    dqkv = _qkv_bwd(qkv, out, lse, dout, heads, new_order, _KERNEL_BWD,
                    "eo_qkv_attention_bwd_mma", dims)
    qkv_attention_bwd_mma_cuda.launches += 1
    return dqkv


qkv_attention_bwd_mma_cuda.launches = 0


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


def _check_planes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, who: str,
                  max_d: Optional[int] = _MAX_D):
    """Raise on q, k, v the separate-tensor kernels do not take (head dims up
    to ``max_d``, None for the routes to say); returns (b, t, h, d)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{who} needs CUDA tensors")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {q.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, T, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if {k.dtype, v.dtype} != {q.dtype} or {k.device, v.device} != {q.device}:
        raise ValueError("q, k, v must share one dtype and device")
    b, t, h, d = q.shape
    if max_d is not None and d > max_d:
        raise ValueError(f"head dim {d} > {max_d}: {who} takes head dims up to {max_d}")
    if d < 8 or d % 8:
        raise ValueError(f"head dim {d}: the kernels take multiples of 8")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the launch grid")
    return b, t, h, d


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """x itself where every ``[B, T, H, D]`` row starts on 16 bytes (unit
    stride along D, positive strides that are multiples of 8, aligned base),
    else a contiguous copy."""
    s = x.stride()
    if s[3] == 1 and min(s[:3]) > 0 and not (s[0] % 8 or s[1] % 8 or s[2] % 8
                                             or x.data_ptr() % 16):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _dense16(x: torch.Tensor) -> torch.Tensor:
    """x itself where it is contiguous with a 16-byte-aligned base, else a copy."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _strides(*xs: torch.Tensor):
    """(batch, token, head) strides of each tensor, in order, as a C array."""
    vals = [st for x in xs for st in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool,
               kernel: str, name: str):
    """One launch of a separate-tensor forward entry on checked, 16-byte-row
    planes; (out, lse or None)."""
    b, t, h, d = q.shape
    fn = _entry(kernel, name)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v), out.data_ptr(),
            lse.data_ptr() if return_lse else None, int(q.dtype == torch.float32), b, t, h,
            d, _scale_in(d, q.dtype), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: error {rc}")
    return out, lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         return_lse: bool = False):
    """Launch the attention forward kernel on three CUDA tensors.

    ``q``, ``k``, ``v`` are ``[B, T, H, D]`` bf16 or float32, any strides
    with unit stride along D (the :func:`split_qkv` views and contiguous
    tensors need no copy; others are copied); returns ``o`` ``[B, T, H, D]``
    contiguous and, with ``return_lse``, ``lse`` ``[B*H, T]`` float32. Any T;
    D a multiple of 8, up to 256 in bf16 (the wgmma/TMA body, which
    ``.launches`` counts) and 128 in float32 (:func:`flash_attention_f32_cuda`;
    :func:`fwd_route`). A wider head goes to :func:`wide_attention_cuda`.
    Those two count their own launches. Raises on anything no kernel takes
    and on a failed launch; never falls back.
    """
    b, t, h, d = _check_planes(q, k, v, "flash_attention_cuda", None)
    q, k, v = _rows16(q), _rows16(k), _rows16(v)
    route = fwd_route(q.dtype, d, [st for x in (q, k, v) for st in x.stride()[:3]],
                      [x.data_ptr() for x in (q, k, v)])
    if route == "wide":
        return wide_attention_cuda(q, k, v, return_lse)
    if route == "tf32x3":
        return flash_attention_f32_cuda(q, k, v, return_lse)
    out, lse = _flash_fwd(q, k, v, return_lse, _KERNEL_SM90, "eo_attention_fwd")
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def _flash_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, who: str):
    """q, k, v checked for the float32 kernels, with 16-byte rows."""
    _check_planes(q, k, v, who)
    if q.dtype != torch.float32:
        raise ValueError(f"{who} takes float32, got {q.dtype}")
    return _rows16(q), _rows16(k), _rows16(v)


def flash_attention_f32_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             return_lse: bool = False):
    """:func:`flash_attention_cuda` in float32: the tensor-core kernel of
    ``csrc/attention_f32_sm90.cu`` (three-term TF32 products), any strides
    with unit stride along D (copied to 16-byte rows where needed), D up to
    128, any T. ``.launches`` counts its launches. Raises on anything it does
    not take and on a failed launch; never falls back."""
    q, k, v = _flash_f32(q, k, v, "flash_attention_f32_cuda")
    out, lse = _flash_fwd(q, k, v, return_lse, _KERNEL_F32, "eo_attention_fwd_tf32x3")
    flash_attention_f32_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_f32_cuda.launches = 0


def _attention_f32_one_term(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            return_lse: bool = False):
    """:func:`flash_attention_f32_cuda` with every product one TF32 product
    (plain TF32, D 48 and 64): the planted fault the accuracy checks must
    catch. No path of the port calls it."""
    q, k, v = _flash_f32(q, k, v, "_attention_f32_one_term")
    out, lse = _flash_fwd(q, k, v, return_lse, _KERNEL_F32, "eo_attention_fwd_tf32x1")
    return (out, lse) if return_lse else out


def flash_attention_mma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             return_lse: bool = False):
    """:func:`flash_attention_cuda` through ``attention_fwd.cu`` (D up to
    128): in bf16 the earlier mma.sync body, which the attention probes copy,
    kept as their yardstick; in float32 the FMA kernel, the yardstick of
    :func:`flash_attention_f32_cuda`. No model path calls it; ``.launches``
    counts its launches."""
    _check_planes(q, k, v, "flash_attention_mma_cuda")
    q, k, v = _rows16(q), _rows16(k), _rows16(v)
    if k.stride(1) != v.stride(1):  # the body reads K and V rows at one token stride
        k, v = k.contiguous(), v.contiguous()
    out, lse = _flash_fwd(q, k, v, return_lse, _KERNEL, "eo_attention_fwd_mma")
    flash_attention_mma_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_mma_cuda.launches = 0


def _saved(q: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor):
    """Raise on a forward's ``out`` / ``lse`` or a ``dout`` that do not fit
    ``q`` ``[B, T, H, D]``; returns them dense on 16 bytes."""
    b, t, h, d = q.shape
    for label, x, shape, dtype in (("out", out, (b, t, h, d), q.dtype),
                                   ("dout", dout, (b, t, h, d), q.dtype),
                                   ("lse", lse, (b * h, t), torch.float32)):
        if x.device != q.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{label}: expected {shape} {dtype} on {q.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return _dense16(out), _dense16(dout), _dense16(lse)


def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
               lse: torch.Tensor, dout: torch.Tensor, dims: Tuple[int, int, int, int],
               kernel: str, name: str):
    """One launch of a separate-tensor backward entry on checked q, k, v of
    ``dims`` (b, t, h, d); (dq, dk, dv)."""
    b, t, h, d = dims
    out, dout, lse = _saved(q, out, lse, dout)
    fn = _entry(kernel, name)
    dq, dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    sc = _scale(d)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, dq, dk, dv), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), int(q.dtype == torch.float32), b, t, h, d,
            _scale_in(d, q.dtype), sc, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: error {rc}")
    return dq, dk, dv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor):
    """Launch the attention backward kernel on separate CUDA tensors.

    ``q``, ``k``, ``v`` as for :func:`flash_attention_cuda`; ``out`` and
    ``lse`` what it returned for them, ``dout`` the gradient of ``out``.
    Returns ``(dq, dk, dv)``, each ``[B, T, H, D]`` contiguous in q's dtype.
    Any T: beyond 4096, where the JAX package recomputes with XLA einsums,
    this kernel computes the same gradient. D a multiple of 8, up to 256 in
    bf16 (the wgmma/TMA body, which ``.launches`` counts) and 128 in float32
    (:func:`flash_attention_bwd_f32_cuda`; :func:`bwd_route`). A wider head
    goes to :func:`wide_attention_bwd_cuda`. Those two count their own
    launches. Raises on anything no kernel takes and on a failed launch;
    never falls back.
    """
    dims = _check_planes(q, k, v, "flash_attention_bwd_cuda", None)
    q, k, v = _rows16(q), _rows16(k), _rows16(v)
    route = bwd_route(q.dtype, dims[3], [st for x in (q, k, v) for st in x.stride()[:3]],
                      [x.data_ptr() for x in (q, k, v)])
    if route == "wide":
        return wide_attention_bwd_cuda(q, k, v, out, lse, dout)
    if route == "tf32x3":
        return flash_attention_bwd_f32_cuda(q, k, v, out, lse, dout)
    grads = _flash_bwd(q, k, v, out, lse, dout, dims, _KERNEL_BWD_SM90, "eo_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return grads


flash_attention_bwd_cuda.launches = 0


def flash_attention_bwd_f32_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor):
    """:func:`flash_attention_bwd_cuda` in float32: the tensor-core backward
    of ``csrc/attention_f32_sm90.cu`` on the tensors of
    :func:`flash_attention_f32_cuda`, ``out`` and ``lse`` what it returned
    for them. Returns ``(dq, dk, dv)``, each ``[B, T, H, D]`` contiguous; no
    atomics, the same bits every call. ``.launches`` counts its calls.
    Raises on anything it does not take and on a failed launch; never falls
    back."""
    q, k, v = _flash_f32(q, k, v, "flash_attention_bwd_f32_cuda")
    grads = _flash_bwd(q, k, v, out, lse, dout, q.shape, _KERNEL_F32, "eo_attention_bwd_tf32x3")
    flash_attention_bwd_f32_cuda.launches += 1
    return grads


flash_attention_bwd_f32_cuda.launches = 0


def _attention_bwd_f32_one_term(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor):
    """:func:`flash_attention_bwd_f32_cuda` with every product one TF32
    product (plain TF32, D 48 and 64): the planted fault the accuracy checks
    must catch. No path of the port calls it."""
    q, k, v = _flash_f32(q, k, v, "_attention_bwd_f32_one_term")
    return _flash_bwd(q, k, v, out, lse, dout, q.shape, _KERNEL_F32, "eo_attention_bwd_tf32x1")


def flash_attention_bwd_mma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor):
    """:func:`flash_attention_bwd_cuda` through ``attention_bwd.cu`` (D up to
    128; bf16: the earlier mma.sync body; float32: the FMA kernel), kept as
    the new bodies' yardstick. No model path calls it; ``.launches`` counts
    its launches."""
    dims = _check_planes(q, k, v, "flash_attention_bwd_mma_cuda")
    q, k, v = _rows16(q), _rows16(k), _rows16(v)
    grads = _flash_bwd(q, k, v, out, lse, dout, dims, _KERNEL_BWD, "eo_attention_bwd_mma")
    flash_attention_bwd_mma_cuda.launches += 1
    return grads


flash_attention_bwd_mma_cuda.launches = 0


def _check_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, who: str,
                max_t: Optional[int] = None):
    """Raise on q, k, v the wide kernels do not take (T above ``max_t``,
    None for any); returns them with 16-byte rows (copied where needed),
    and (b, t, h, d)."""
    dims = _check_planes(q, k, v, who, None)
    if max_t is not None and dims[1] > max_t:
        raise ValueError(f"T {dims[1]} > {max_t}: {who} holds a row block of scores in "
                         f"shared memory")
    return _rows16(q), _rows16(k), _rows16(v), dims


def wide_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        return_lse: bool = False):
    """Launch the wide-head attention forward (``csrc/attention_wide.cu``) on
    three CUDA tensors: ``[B, T, H, D]`` bf16 or float32 with unit stride
    along D (copied to 16-byte rows where needed), any D that is a multiple
    of 8, any T; keys streamed with an online softmax, bf16 on the tensor
    cores. It computes :func:`reference_attention`'s function;
    :func:`flash_attention_cuda` sends it the head dims its bodies do not
    take. Returns ``o`` ``[B, T, H, D]`` contiguous and, with ``return_lse``,
    ``lse`` ``[B*H, T]`` float32; ``.launches`` counts its launches. Raises
    on anything it does not take and on a failed launch; never falls back."""
    q, k, v, _ = _check_wide(q, k, v, "wide_attention_cuda")
    out, lse = _flash_fwd(q, k, v, return_lse, _KERNEL_WIDE, "eo_attention_wide_fwd")
    wide_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


wide_attention_cuda.launches = 0


def wide_attention_resident_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 return_lse: bool = False):
    """:func:`wide_attention_cuda` through the first wide forward
    (``csrc/attention_wide_resident.cu``: a CTA's 16 rows of scores whole in
    shared memory, FMA, T up to 1024), kept as the new body's yardstick. No
    model path calls it; ``.launches`` counts its launches."""
    q, k, v, _ = _check_wide(q, k, v, "wide_attention_resident_cuda", _RESIDENT_MAX_T)
    out, lse = _flash_fwd(q, k, v, return_lse, _KERNEL_WIDE_RESIDENT,
                          "eo_attention_wide_resident_fwd")
    wide_attention_resident_cuda.launches += 1
    return (out, lse) if return_lse else out


wide_attention_resident_cuda.launches = 0


def _wide_bwd(q, k, v, out, lse, dout, who, max_t=None):
    """Checked, 16-byte-row q, k, v, the saved ``out``, ``dout``, ``lse``
    dense, fresh ``dq, dk, dv`` and the head dim's scale pair."""
    q, k, v, (b, t, h, d) = _check_wide(q, k, v, who, max_t)
    out, dout, lse = _saved(q, out, lse, dout)
    grads = [torch.empty((b, t, h, d), dtype=q.dtype, device=q.device) for _ in range(3)]
    sc = _scale(d)
    return q, k, v, out, dout, lse, grads, (_scale_in(d, q.dtype), sc)


def wide_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor):
    """Launch the wide-head attention backward (``csrc/attention_wide.cu``: a
    delta kernel, then the dq, dk and dv jobs, each recomputing p from the
    saved lse, so no buffer of T x T elements; no atomics, the same bits on
    every call) on the tensors of :func:`wide_attention_cuda`, ``out`` and
    ``lse`` what it returned for them and ``dout`` the gradient of ``out``.
    Returns ``(dq, dk, dv)``, each ``[B, T, H, D]`` contiguous in q's dtype:
    :func:`reference_attention_bwd`'s function, at any T. ``.launches``
    counts its calls. Raises on anything it does not take and on a failed
    launch; never falls back."""
    q, k, v, out, dout, lse, (dq, dk, dv), (s_in, sc) = _wide_bwd(
        q, k, v, out, lse, dout, "wide_attention_bwd_cuda")
    b, t, h, d = q.shape
    delta = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    rc = _entry(_KERNEL_WIDE, "eo_attention_wide_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), int(q.dtype == torch.float32), b, t, h, d, s_in, sc,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL_WIDE} launch failed: error {rc}")
    wide_attention_bwd_cuda.launches += 1
    return dq, dk, dv


wide_attention_bwd_cuda.launches = 0


def wide_attention_bwd_resident_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     out: torch.Tensor, lse: torch.Tensor,
                                     dout: torch.Tensor):
    """:func:`wide_attention_bwd_cuda` through the first wide backward
    (``csrc/attention_wide_resident.cu``: two FMA kernels through a ``[2,
    B*H, T, T]`` scratch, T up to 1024), kept as the new body's yardstick. No
    model path calls it; ``.launches`` counts its calls."""
    q, k, v, out, dout, lse, (dq, dk, dv), (s_in, sc) = _wide_bwd(
        q, k, v, out, lse, dout, "wide_attention_bwd_resident_cuda", _RESIDENT_MAX_T)
    b, t, h, d = q.shape
    scratch = torch.empty((2, b * h, t, t), dtype=q.dtype, device=q.device)
    rc = _entry(_KERNEL_WIDE_RESIDENT, "eo_attention_wide_resident_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(), int(q.dtype == torch.float32), b, t,
        h, d, s_in, sc, q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL_WIDE_RESIDENT} launch failed: error {rc}")
    wide_attention_bwd_resident_cuda.launches += 1
    return dq, dk, dv


wide_attention_bwd_resident_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention on three ``[B, T, H, D]`` tensors with a kernel on both
    sides: the port of the JAX package's ``flash_attention`` ``custom_vjp``
    (``ops/attention.py:642-678``).

    Forward: on CUDA :func:`flash_attention_cuda`, asking for the row
    logsumexp only when an input needs a gradient; on the CPU the plain
    version. Backward: on CUDA :func:`flash_attention_bwd_cuda` at every T,
    on the CPU :func:`reference_attention_bwd`.
    """

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        need = any(ctx.needs_input_grad)
        if q.is_cuda:
            res = flash_attention_cuda(q, k, v, return_lse=need)
        elif q.device.type == "cpu":
            res = reference_attention(q, k, v, return_lse=need)
        else:
            raise ValueError(f"no attention kernel for device {q.device}")
        out, lse = res if need else (res, None)
        if need:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            return flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        return reference_attention_bwd(q, k, v, out, lse, dout)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """Attention, ``[B, T, H, D]`` x3 -> ``[B, T, H, D]``: the port of the JAX
    package's ``flash_attention`` (``ops/attention.py:643``).

    ``impl="auto"`` goes through :class:`FlashAttention`: the CUDA kernels for
    CUDA tensors, forward and backward, whatever T is (one streaming kernel
    covers the JAX package's resident and grid-tiled regimes, so there are no
    ``block_q``/``block_k`` knobs); the plain versions for CPU tensors.
    ``impl="plain"``: the plain version on any device, under ordinary
    autograd. With no gradient recorded, the auto path is the
    ``eo::flash_attention`` custom op (:mod:`~eo_diffusion_torch.ops.library`).
    """
    if impl == "plain":
        return reference_attention(q, k, v)
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    from eo_diffusion_torch.ops import library

    if library.sampling_call(q):  # no autograd: the eo:: custom op
        return torch.ops.eo.flash_attention(q, k, v)
    return FlashAttention.apply(q, k, v)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The port of the JAX package's ``fused_attention`` (``ops/attention.py:681``).

    It has no ``min_seq``: where the JAX package sends short sequences and
    CPU arrays to XLA einsums, this launches the kernel on a CUDA tensor
    whatever T is, as :func:`attention_from_qkv` does, and runs the plain
    version on a CPU tensor. Otherwise it is :func:`flash_attention`.
    """
    return flash_attention(q, k, v)


def _qkv_kernel_takes(t: int, d: int) -> bool:
    """Whether the JAX package sends T tokens of head dim d to its fused-qkv
    kernel K1 (``attention_from_qkv``'s gate, ``ops/attention.py:927-935``,
    at its default blocks); the other shapes go to ``fused_attention``."""
    block_q = t if t <= 1024 else 512
    bq, bk = min(block_q, t), min(2048, t)
    return t % bq == 0 and t % bk == 0 and bq % 8 == 0 and d <= 128 and t <= _MAX_QKV_T


def attention_from_qkv(qkv: torch.Tensor, heads: int, new_order: bool = False,
                       impl: str = "auto", return_lse: bool = False
                       ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention straight from the fused projection: ``[B, T, 3C]`` ->
    ``[B, T, C]`` with channel ``h*D + d``.

    ``impl="auto"``: where the JAX package runs its fused-qkv kernel
    (:func:`_qkv_kernel_takes`: T <= 4096 in its aligned blocks, e.g. the
    clouds UNet at 256 px) through :class:`QKVAttention`, elsewhere (e.g. T
    2304, 9216 and 16384 at 384 and 512 px, or the head dim 1024 of
    ``inria64``'s middle block at any image size, which the wide kernels
    take) through
    :class:`FlashAttention` on the :func:`split_qkv` views: the CUDA kernels
    for a CUDA tensor (forward and backward), the plain versions for a CPU
    tensor.
    ``impl="plain"``: the plain version on any device, under ordinary
    autograd.
    ``return_lse`` also returns the ``[B*H, T]`` row logsumexp and
    is for inspection only: that call carries no gradient on the auto path.
    Inside :func:`identity_attention` it returns v, whatever ``impl``.
    With no gradient recorded (sampling) the auto path calls the same
    kernels, or plain versions, as the ``eo::`` custom ops of
    :mod:`~eo_diffusion_torch.ops.library`, which ``torch.export`` traces.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    b, t, c3 = qkv.shape
    if _IDENTITY:
        # PAG's perturbed branch: v in the block's channel layout, no kernel
        global _IDENTITY_HITS
        _IDENTITY_HITS += 1
        d = c3 // 3 // heads
        v = (qkv.reshape(b, t, 3, heads, d)[:, :, 2] if new_order
             else qkv.reshape(b, t, heads, 3, d)[:, :, :, 2])
        return v.reshape(b, t, c3 // 3)
    fused = _qkv_kernel_takes(t, c3 // 3 // heads)
    if impl == "auto" and not return_lse:
        from eo_diffusion_torch.ops import library

        if library.sampling_call(qkv):  # no autograd: the eo:: custom ops
            if fused:
                return torch.ops.eo.qkv_attention(qkv, heads, new_order)
            return torch.ops.eo.flash_attention(
                *split_qkv(qkv, heads, new_order)).reshape(b, t, c3 // 3)
        if fused:
            return QKVAttention.apply(qkv, heads, new_order)
        return FlashAttention.apply(*split_qkv(qkv, heads, new_order)).reshape(b, t, c3 // 3)
    if impl == "auto" and qkv.is_cuda:
        if fused:
            return qkv_attention_cuda(qkv, heads, new_order, return_lse)
        out, lse = flash_attention_cuda(*split_qkv(qkv, heads, new_order), return_lse=True)
        return out.reshape(b, t, c3 // 3), lse
    if impl == "auto" and qkv.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    res = reference_attention(*split_qkv(qkv, heads, new_order), return_lse=return_lse)
    if return_lse:
        return res[0].reshape(b, t, c3 // 3), res[1]
    return res.reshape(b, t, c3 // 3)
