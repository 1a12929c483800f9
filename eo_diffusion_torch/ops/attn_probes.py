"""The attention-matmul probes: plain PyTorch versions and their Hopper kernels.

Counterparts of two of the JAX package's measurement kernels:

* the batched matmul probe (``tools/probe_attn_matmuls.py``, the body of
  ``_bench`` :38, ``pallas_call`` :45): per cell of ``[BH]``, ``NK * (A B)``
  with bf16 inputs and f32 output in three contraction layouts (:data:`LAYOUTS`):
  ``"nt"`` a ``[M, K]``, b ``[N, K]`` (QKᵀ); ``"nn"`` a ``[M, K]``, b ``[K, N]``
  (PV); ``"tn"`` a ``[K, M]``, b ``[K, N]`` (the transposed PV).
  :func:`matmul_probe_reference` is the plain version (f32 ``einsum``; on the
  card TF32 must be off), :func:`matmul_probe_cuda` launches the kernel,
  :func:`matmul_probe` is the entry.
* attention with a transposed output (``tools/probe_packed_pv.py``,
  ``kern_transposed`` :52 via ``transposed_attn`` :86): ``qkv5 [B, 3, H, T,
  D] -> o [B, H, D, T]`` in qkv5's dtype, q and k each scaled by ``D^-1/4``
  in that dtype, f32 softmax. :func:`transposed_attention_reference` is the
  plain version (the port's plain attention a sample at a time, then a
  transpose), :func:`transposed_attention_cuda` launches the kernel,
  :func:`transposed_attention` is the entry.

* the softmax-orientation probe's hybrid attentions
  (``tools/probe_softmax_orient.py``, ``kern_hybrid`` :117 via
  ``hybrid_attn`` :153 and ``kern_hybrid2`` :205 via ``hybrid2_attn`` :238):
  the same function as the transposed-output attention, with PV computed
  transposed (``accᵀ [D, bq] = Vᵀ Pᵀ``); :data:`HYBRIDS` names the two ways p
  reaches the second product. :func:`transposed_attention_reference` is their
  plain version too, :func:`hybrid_attention_cuda` launches the kernel,
  :func:`hybrid_attention` is the entry.

The kernels live in ``csrc/attn_probes.cu``. An entry takes the kernel for
CUDA tensors (or raises) and the plain version for CPU tensors. No model
path calls any of them: they are the port's measurement tools' kernels
(``eo_diffusion_torch/tools/probe_attn_matmuls.py``, ``probe_packed_pv.py``,
``probe_softmax_orient.py``).
"""

from __future__ import annotations

import ctypes

import torch

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops.attention import _dense16, _scale, reference_attention

__all__ = ["LAYOUTS", "NK", "HYBRIDS", "matmul_probe_reference", "matmul_probe_cuda",
           "matmul_probe", "transposed_attention_reference", "transposed_attention_cuda",
           "transposed_attention", "hybrid_attention_cuda", "hybrid_attention"]

_KERNEL = "attn_probes"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"eo_matmul_probe": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
             "eo_attention_fwd_transposed": [_P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
             "eo_attention_hybrid": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]}
#: contraction layout -> (its code in the kernel, einsum of one cell)
LAYOUTS = {"nt": (0, "mk,nk->mn"), "nn": (1, "mk,kn->mn"), "tn": (2, "km,kn->mn")}
#: products a cell computes and sums, as the probe's ``_bench`` body does
NK = 2
#: the hybrid attentions -> whether p reaches the PV^T product through shared
#: memory (``kern_hybrid``'s explicit ``.T``) or in registers (``kern_hybrid2``)
HYBRIDS = {"hybrid": 1, "hybrid2": 0}
#: keys a K/V stage of the hybrid kernel (its register score tile); D <= 64
#: also takes 2 and 4 times as many
HYBRID_KEYS = 64


def _entry(name: str):
    fn = getattr(_build.load(_KERNEL), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    return fn


def _probe_dims(a: torch.Tensor, b: torch.Tensor, layout: str):
    """(BH, M, N, K) of a probe's operands; raises on a mismatch."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(LAYOUTS)}, got {layout!r}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a and b must be [BH, .., ..], got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    bh = a.shape[0]
    if layout == "nt":
        (m, k), (n, kb) = a.shape[1:], b.shape[1:]
    elif layout == "nn":
        (m, k), (kb, n) = a.shape[1:], b.shape[1:]
    else:
        (k, m), (kb, n) = a.shape[1:], b.shape[1:]
    if k != kb:
        raise ValueError(f"contraction sizes differ: {k} and {kb} ({layout})")
    return bh, m, n, k


def matmul_probe_reference(a: torch.Tensor, b: torch.Tensor, layout: str) -> torch.Tensor:
    """:data:`NK` times the product of each cell in f32: ``[BH, M, N]``
    float32."""
    _probe_dims(a, b, layout)
    return torch.einsum("z" + LAYOUTS[layout][1].replace(",", ",z").replace("->", "->z"),
                        a.float(), b.float()) * NK


def matmul_probe_cuda(a: torch.Tensor, b: torch.Tensor, layout: str) -> torch.Tensor:
    """Launch the probe kernel on bf16 CUDA tensors (M, N and K multiples of
    8; non-contiguous inputs are copied): ``[BH, M, N]`` float32. Raises on
    anything it does not take and on a failed launch; never falls back."""
    bh, m, n, k = _probe_dims(a, b, layout)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("matmul_probe_cuda needs a and b on one CUDA device")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"the probe kernel takes bf16, got {a.dtype}, {b.dtype}")
    if min(m, n, k) < 8 or m % 8 or n % 8 or k % 8 or bh > 65535:
        raise ValueError(f"M {m}, N {n}, K {k}: the probe kernel takes multiples of 8 "
                         f"(BH {bh} <= 65535)")
    a, b = _dense16(a), _dense16(b)
    out = torch.empty(bh, m, n, dtype=torch.float32, device=a.device)
    rc = _entry("eo_matmul_probe")(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   LAYOUTS[layout][0], bh, m, n, k, NK, a.device.index,
                                   torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"matmul_probe launch failed: error {rc}")
    matmul_probe_cuda.launches += 1
    return out


matmul_probe_cuda.launches = 0


def matmul_probe(a: torch.Tensor, b: torch.Tensor, layout: str) -> torch.Tensor:
    """The probe's product: the kernel for CUDA tensors (or a raise), the
    plain version for CPU tensors."""
    if a.is_cuda:
        return matmul_probe_cuda(a, b, layout)
    if a.device.type != "cpu":
        raise ValueError(f"no probe kernel for device {a.device}")
    return matmul_probe_reference(a, b, layout)


def transposed_attention_reference(qkv5: torch.Tensor) -> torch.Tensor:
    """``[B, 3, H, T, D] -> [B, H, D, T]`` with the port's plain attention
    (``ops.attention.reference_attention``), a sample at a time (its f32
    scores are ``[H, T, T]``: 537 MB at H 8, T 4096)."""
    if qkv5.dim() != 5 or qkv5.shape[1] != 3:
        raise ValueError(f"qkv5 must be [B, 3, H, T, D], got {tuple(qkv5.shape)}")
    outs = []
    for sample in qkv5.split(1):
        q, k, v = (sample[:, j].transpose(1, 2) for j in range(3))  # [1, T, H, D]
        outs.append(reference_attention(q, k, v).permute(0, 2, 3, 1))
    return torch.cat(outs).contiguous()


def _check_qkv5(qkv5: torch.Tensor):
    if qkv5.dim() != 5 or qkv5.shape[1] != 3:
        raise ValueError(f"qkv5 must be [B, 3, H, T, D], got {tuple(qkv5.shape)}")
    b, _, h, t, d = qkv5.shape
    if d < 8 or d > 128 or d % 8:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up to 128")
    if t < 1 or b * h > 65535:
        raise ValueError(f"T {t}, B*H {b * h}: the kernel takes T >= 1, B*H <= 65535")
    return b, h, t, d


def transposed_attention_cuda(qkv5: torch.Tensor) -> torch.Tensor:
    """Launch the transposed-output attention kernel on a CUDA tensor ``[B, 3,
    H, T, D]`` (bf16 or float32; any T, D a multiple of 8 up to 128; a
    non-contiguous input is copied). Returns ``o`` ``[B, H, D, T]`` in its
    dtype. Raises on anything it does not take and on a failed launch; never
    falls back."""
    if not qkv5.is_cuda:
        raise ValueError("transposed_attention_cuda needs a CUDA tensor")
    if qkv5.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {qkv5.dtype}")
    b, h, t, d = _check_qkv5(qkv5)
    qkv5 = _dense16(qkv5)
    out = torch.empty(b, h, d, t, dtype=qkv5.dtype, device=qkv5.device)
    # q*s and k*s round in the input dtype: hand the kernel s in that dtype
    scale = float(torch.tensor(_scale(d), dtype=qkv5.dtype))
    rc = _entry("eo_attention_fwd_transposed")(
        qkv5.data_ptr(), out.data_ptr(), int(qkv5.dtype == torch.float32), b, h, t, d, scale,
        qkv5.device.index, torch.cuda.current_stream(qkv5.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd_transposed launch failed: error {rc}")
    transposed_attention_cuda.launches += 1
    return out


transposed_attention_cuda.launches = 0


def transposed_attention(qkv5: torch.Tensor) -> torch.Tensor:
    """``[B, 3, H, T, D] -> [B, H, D, T]``: the kernel for a CUDA tensor (or a
    raise), the plain version for a CPU tensor."""
    if qkv5.is_cuda:
        return transposed_attention_cuda(qkv5)
    if qkv5.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {qkv5.device}")
    return transposed_attention_reference(qkv5)


def _check_hybrid(qkv5: torch.Tensor, variant: str, block_k: int):
    """Raise on a variant, stage depth or shape the hybrid kernel does not
    take; returns (b, h, t, d)."""
    if variant not in HYBRIDS:
        raise ValueError(f"variant must be one of {sorted(HYBRIDS)}, got {variant!r}")
    b, h, t, d = _check_qkv5(qkv5)
    if block_k not in ((HYBRID_KEYS, 2 * HYBRID_KEYS, 4 * HYBRID_KEYS) if d <= 64
                       else (HYBRID_KEYS,)):
        raise ValueError(f"block_k {block_k} at D {d}: the kernel takes {HYBRID_KEYS}, and 2 "
                         f"or 4 times that for D <= 64")
    return b, h, t, d


def hybrid_attention_cuda(qkv5: torch.Tensor, variant: str = "hybrid2",
                          block_k: int = HYBRID_KEYS) -> torch.Tensor:
    """Launch the hybrid attention kernel on a bf16 CUDA tensor ``[B, 3, H, T,
    D]`` (any T, D a multiple of 8 up to 128; a non-contiguous input is
    copied), p handed to PV^T as :data:`HYBRIDS` says, ``block_k`` keys a K/V
    stage (64, or for D <= 64 also 128 or 256). Returns ``o`` ``[B, H, D, T]``
    bf16. Raises on anything it does not take and on a failed launch; never
    falls back."""
    if not qkv5.is_cuda:
        raise ValueError("hybrid_attention_cuda needs a CUDA tensor")
    if qkv5.dtype != torch.bfloat16:
        raise ValueError(f"the hybrid kernel takes bf16 (the TPU probe's dtype), got "
                         f"{qkv5.dtype}")
    b, h, t, d = _check_hybrid(qkv5, variant, block_k)
    qkv5 = _dense16(qkv5)
    out = torch.empty(b, h, d, t, dtype=qkv5.dtype, device=qkv5.device)
    scale = float(torch.tensor(_scale(d), dtype=qkv5.dtype))
    rc = _entry("eo_attention_hybrid")(
        qkv5.data_ptr(), out.data_ptr(), HYBRIDS[variant], b, h, t, d, block_k, scale,
        qkv5.device.index, torch.cuda.current_stream(qkv5.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_hybrid launch failed: error {rc}")
    hybrid_attention_cuda.launches += 1
    return out


hybrid_attention_cuda.launches = 0


def hybrid_attention(qkv5: torch.Tensor, variant: str = "hybrid2",
                     block_k: int = HYBRID_KEYS) -> torch.Tensor:
    """``[B, 3, H, T, D] -> [B, H, D, T]`` computed the hybrids' way: the kernel
    for a CUDA tensor (or a raise), the plain version for a CPU tensor (the
    same function as :func:`transposed_attention`, so ``variant`` and
    ``block_k`` change nothing there but are checked)."""
    if qkv5.is_cuda:
        return hybrid_attention_cuda(qkv5, variant, block_k)
    if qkv5.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {qkv5.device}")
    _check_hybrid(qkv5, variant, block_k)
    return transposed_attention_reference(qkv5)
