"""Attention-variant probes: plain PyTorch versions and their Hopper kernel.

Counterparts of the JAX package's attention experiments at the 256 px
headline's ds-4 shape (B8 T4096 H8 D48):

* ``tools/profile_attn_variants.py`` (``kern_A`` :28 to ``kern_D`` :56,
  launched by ``run`` :66, call :77) and ``tools/profile_attn_variants2.py``
  (``kern_chunked`` :28, ``run`` :51, call :62): q, k, v ``[B, T, H, D]`` ->
  o ``[B, T, H, D]``, q and k scaled by ``D^-1/4`` in their dtype, f32 scores,
  p rounded to the input dtype before PV, in the variants of
  :data:`VARIANTS`: A normalises p before PV, B after it (K1's recipe;
  ``kern_chunked`` is B at other tiles), C skips max and exp (wrong on
  purpose), D skips the max (wrong for large scores).
  :func:`attention_variant_reference` is the plain version,
  :func:`attention_variant_cuda` launches the kernel (``csrc/attn_variants.cu``)
  at a tile of ``warps`` x 32 query rows and ``block_k`` keys a K/V stage,
  :func:`attention_variant` is the entry.
* ``tools/profile_attn_fusedlayout.py`` (``kern`` :28 via
  ``fused_layout_attn`` :54, call :61): attention read from the fused ``[B,
  T, 3, H, D]`` tensor and written as ``[B, T, H, D]``. That is the fused
  projection in the new head order, so its Hopper kernel is K1's:
  :func:`fused_layout_attention` launches ``ops.attention.qkv_attention_cuda``
  (``new_order=True``) on a CUDA tensor and runs the plain attention on a
  CPU one; no second copy of K1's body exists.

An entry takes the kernel for CUDA tensors (or raises) and the plain version
for CPU tensors. No model path calls any of them: they are the kernels of the
port's tools ``eo_diffusion_torch/tools/profile_attn_variants.py``,
``profile_attn_variants2.py`` and ``profile_attn_fusedlayout.py``.
"""

from __future__ import annotations

import ctypes

import torch

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops import attention as A

__all__ = ["VARIANTS", "K1_TILE", "TILES", "attention_variant_reference",
           "attention_variant_cuda", "attention_variant", "fused_layout_attention_reference",
           "fused_layout_attention"]

_KERNEL = "attn_variants"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]
#: variant -> its code in the kernel
VARIANTS = {"A": 0, "B": 1, "C": 2, "D": 3}
#: K1's tile: (warps of 32 query rows a block, keys a K/V stage)
K1_TILE = (4, 64)
#: the tiles the kernel takes: every variant at 4 and 8 warps by 64 keys a
#: stage, B (``kern_chunked``'s sweep) also at 16 warps and 128 keys
TILES = {v: ((4, 64), (8, 64)) for v in "ACD"}
TILES["B"] = tuple((w, bk) for w in (4, 8, 16) for bk in (64, 128))
_MAX_D = 64


def _entry():
    fn = _build.load(_KERNEL).eo_attention_variant
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check_variant(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, got {variant!r}")


def _check_tile(variant: str, warps: int, block_k: int):
    _check_variant(variant)
    if (warps, block_k) not in TILES[variant]:
        raise ValueError(f"variant {variant} runs at (warps, block_k) in {TILES[variant]}, "
                         f"got {(warps, block_k)}")


def attention_variant_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                variant: str) -> torch.Tensor:
    """The variant's function in f32 torch ops, a sample at a time (the f32
    scores of one B8 T4096 H8 sample are 537 MB): q ``[B, T, H, D]``, k and v
    ``[B, S, H, D]`` -> ``[B, T, H, D]`` in q's dtype, rounding where the JAX
    kernels round. On the card it needs
    ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    _check_variant(variant)
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4
            or (k.shape[0], *k.shape[2:]) != (q.shape[0], *q.shape[2:])):
        raise ValueError(f"q [B, T, H, D] and k, v [B, S, H, D]: shapes do not fit, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    dt = q.dtype
    s = torch.tensor(A._scale(q.shape[-1]), dtype=dt)
    outs = []
    for i in range(q.shape[0]):
        qs, ks = ((x[i] * s).float().transpose(0, 1) for x in (q, k))  # [H, T, D]
        vf = v[i].float().transpose(0, 1)
        sc = qs @ ks.mT  # [H, T, T]
        if variant == "C":
            o = sc.to(dt).float() @ vf
        elif variant == "D":
            p = torch.exp(sc)
            o = (p.to(dt).float() @ vf) / p.sum(-1, keepdim=True)
        else:
            p = torch.exp(sc - sc.amax(-1, keepdim=True))
            l = p.sum(-1, keepdim=True)
            o = (p / l).to(dt).float() @ vf if variant == "A" else (p.to(dt).float() @ vf) / l
        outs.append(o.transpose(0, 1).to(dt))
    return torch.stack(outs)


def attention_variant_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str,
                           warps: int = K1_TILE[0], block_k: int = K1_TILE[1]) -> torch.Tensor:
    """Launch the variant kernel on three bf16 CUDA tensors ``[B, T, H, D]``
    (any T, D a multiple of 8 up to 64; non-contiguous ones are copied) at
    ``warps`` x 32 query rows a block and ``block_k`` keys a K/V stage, one
    of the variant's :data:`TILES`. Returns ``o`` ``[B, T, H, D]`` bf16. Raises
    on anything it does not take and on a failed launch; never falls back."""
    _check_tile(variant, warps, block_k)
    b, t, h, d = A._check_planes(q, k, v, "attention_variant_cuda")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the variant kernel takes bf16 (the probe's dtype), got {q.dtype}")
    if d > _MAX_D:
        raise ValueError(f"head dim {d}: the variant kernel takes multiples of 8 up to {_MAX_D}")
    q, k, v = (A._dense16(x) for x in (q, k, v))
    out = torch.empty_like(q)
    scale = float(torch.tensor(A._scale(d), dtype=q.dtype))
    rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  VARIANTS[variant], warps, block_k, b, t, h, d, scale, q.device.index,
                  torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_variant launch failed: error {rc}")
    attention_variant_cuda.launches += 1
    return out


attention_variant_cuda.launches = 0


def attention_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str,
                      warps: int = K1_TILE[0], block_k: int = K1_TILE[1]) -> torch.Tensor:
    """The variant: the kernel for CUDA tensors (or a raise), the plain
    version for CPU tensors (the tile is checked but changes nothing there)."""
    if q.is_cuda:
        return attention_variant_cuda(q, k, v, variant, warps, block_k)
    if q.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check_tile(variant, warps, block_k)
    if k.shape != q.shape or v.shape != q.shape:  # as the kernel takes them
        raise ValueError(f"q, k, v must share one [B, T, H, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return attention_variant_reference(q, k, v, variant)


def _check_fused(qkv: torch.Tensor):
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be [B, T, 3, H, D], got {tuple(qkv.shape)}")
    return qkv.shape


def fused_layout_attention_reference(qkv: torch.Tensor) -> torch.Tensor:
    """``[B, T, 3, H, D] -> [B, T, H, D]``: the port's plain attention on the
    three planes."""
    _check_fused(qkv)
    return A.reference_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])


def fused_layout_attention(qkv: torch.Tensor) -> torch.Tensor:
    """``[B, T, 3, H, D] -> [B, T, H, D]``: on a CUDA tensor K1's kernel through
    its fused-projection entry in the new head order (``qkv`` read where it
    lies, any T; it counts its launches in ``qkv_attention_cuda.launches``),
    or a raise; on a CPU tensor the plain version."""
    b, t, _, h, d = _check_fused(qkv)
    if qkv.is_cuda:
        out = A.qkv_attention_cuda(qkv.reshape(b, t, 3 * h * d), h, new_order=True)
        return out.reshape(b, t, h, d)
    if qkv.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    return fused_layout_attention_reference(qkv)
