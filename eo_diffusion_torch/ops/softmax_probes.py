"""The softmax-orientation probes: plain PyTorch versions and their Hopper kernels.

Counterparts of two measurement kernels of the JAX package's softmax
orientation probe (``tools/probe_softmax_orient.py``):

* the softmax statistics (``_cellwise`` :52 with ``bench_reduce``'s body :64,
  ``pallas_call`` :53): per cell of ``s [BH, M, N]`` float32, ``r = max +
  sum(exp(s - max))`` along ``axis`` of the cell (1: each row, the TPU's lane
  reduction, out ``[BH, M, 1]``; 0: each column, its sublane reduction, out
  ``[BH, 1, N]``), summed :data:`NK` times in f32. :func:`softmax_stats_reference`
  is the plain version, :func:`softmax_stats_cuda` launches the kernel,
  :func:`softmax_stats` is the entry.
* the transpose (``bench_transpose``'s body :90, ``pallas_call`` :97): ``[BH,
  M, N] -> [BH, N, M]``, ``pᵀ`` summed :data:`NK` times in p's dtype, then
  widened to float32. :func:`transpose_accumulate_reference`,
  :func:`transpose_accumulate_cuda` (bf16, the probe's dtype) and
  :func:`transpose_accumulate`.

Both kernels live in ``csrc/softmax_probes.cu``. An entry takes the kernel for
a CUDA tensor (or raises) and the plain version for a CPU tensor. No model
path calls either: they are the kernels of the port's measurement tool
``eo_diffusion_torch/tools/probe_softmax_orient.py``.
"""

from __future__ import annotations

import ctypes

import torch

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops.attention import _dense16

__all__ = ["NK", "softmax_stats_reference", "softmax_stats_cuda", "softmax_stats",
           "transpose_accumulate_reference", "transpose_accumulate_cuda",
           "transpose_accumulate"]

_KERNEL = "softmax_probes"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"eo_softmax_stats": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
             "eo_transpose_accumulate": [_P, _P, _I, _I, _I, _I, _I, _P]}
#: times a probe body computes its value and adds it, as the JAX bodies do
NK = 2


def _entry(name: str):
    fn = getattr(_build.load(_KERNEL), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    return fn


def _check_cells(x: torch.Tensor, who: str):
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"{who} takes cells [BH, M, N], got {tuple(x.shape)}")
    return x.shape


def softmax_stats_reference(s: torch.Tensor, axis: int) -> torch.Tensor:
    """``NK * (max + sum(exp(s - max)))`` along ``axis`` (1 or 0) of each cell of
    ``s [BH, M, N]``, float32, keeping the reduced axis: ``[BH, M, 1]`` or
    ``[BH, 1, N]``."""
    _check_cells(s, "softmax_stats")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 1 (rows) or 0 (columns), got {axis!r}")
    s = s.float()
    m = s.amax(dim=axis + 1, keepdim=True)
    r = m + torch.exp(s - m).sum(dim=axis + 1, keepdim=True)
    acc = r
    for _ in range(NK - 1):
        acc = acc + r
    return acc


def softmax_stats_cuda(s: torch.Tensor, axis: int) -> torch.Tensor:
    """Launch the statistics kernel on a float32 CUDA tensor ``[BH, M, N]``
    (a non-contiguous one is copied). Raises on anything it does not take and
    on a failed launch; never falls back."""
    bh, m, n = _check_cells(s, "softmax_stats_cuda")
    if not s.is_cuda:
        raise ValueError("softmax_stats_cuda needs a CUDA tensor")
    if s.dtype != torch.float32:
        raise ValueError(f"the statistics kernel takes float32 scores, got {s.dtype}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 1 (rows) or 0 (columns), got {axis!r}")
    if axis == 0 and bh > 65535:
        raise ValueError(f"BH {bh} > 65535: the column kernel's launch grid")
    s = _dense16(s)
    out = torch.empty((bh, m, 1) if axis == 1 else (bh, 1, n), dtype=torch.float32,
                      device=s.device)
    rc = _entry("eo_softmax_stats")(s.data_ptr(), out.data_ptr(), axis, bh, m, n, NK,
                                    s.device.index, torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"softmax_stats launch failed: error {rc}")
    softmax_stats_cuda.launches += 1
    return out


softmax_stats_cuda.launches = 0


def softmax_stats(s: torch.Tensor, axis: int) -> torch.Tensor:
    """The statistics: the kernel for a CUDA tensor (or a raise), the plain
    version for a CPU tensor."""
    if s.is_cuda:
        return softmax_stats_cuda(s, axis)
    if s.device.type != "cpu":
        raise ValueError(f"no statistics kernel for device {s.device}")
    return softmax_stats_reference(s, axis)


def transpose_accumulate_reference(p: torch.Tensor) -> torch.Tensor:
    """``pᵀ`` of each cell of ``p [BH, M, N]`` summed ``NK`` times in p's
    dtype, then float32: ``[BH, N, M]``."""
    _check_cells(p, "transpose_accumulate")
    pt = p.mT
    acc = pt
    for _ in range(NK - 1):
        acc = acc + pt
    return acc.to(torch.float32, memory_format=torch.contiguous_format)


def transpose_accumulate_cuda(p: torch.Tensor) -> torch.Tensor:
    """Launch the transpose kernel on a bf16 CUDA tensor ``[BH, M, N]`` (a
    non-contiguous one is copied): ``[BH, N, M]`` float32. Raises on anything
    it does not take and on a failed launch; never falls back."""
    bh, m, n = _check_cells(p, "transpose_accumulate_cuda")
    if not p.is_cuda:
        raise ValueError("transpose_accumulate_cuda needs a CUDA tensor")
    if p.dtype != torch.bfloat16:
        raise ValueError(f"the transpose kernel takes bf16 (the probe's dtype), got {p.dtype}")
    if bh > 65535 or (m + 31) // 32 > 65535:
        raise ValueError(f"BH {bh}, M {m}: past the transpose kernel's launch grid")
    p = _dense16(p)
    out = torch.empty(bh, n, m, dtype=torch.float32, device=p.device)
    rc = _entry("eo_transpose_accumulate")(p.data_ptr(), out.data_ptr(), bh, m, n, NK,
                                           p.device.index,
                                           torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"transpose_accumulate launch failed: error {rc}")
    transpose_accumulate_cuda.launches += 1
    return out


transpose_accumulate_cuda.launches = 0


def transpose_accumulate(p: torch.Tensor) -> torch.Tensor:
    """The transpose: the kernel for a CUDA tensor (or a raise), the plain
    version for a CPU tensor."""
    if p.is_cuda:
        return transpose_accumulate_cuda(p)
    if p.device.type != "cpu":
        raise ValueError(f"no transpose kernel for device {p.device}")
    return transpose_accumulate_reference(p)
