"""Device-resident dataset cache: batches gathered on the card, no host I/O.

The port's counterpart of the JAX package's ``data/device_cache.py``. For
patch datasets that fit device memory (a few GB -- most EO patch sets after
windowing) the data is uploaded once; every training step then gathers a
random batch on the device, with per-sample horizontal and vertical flips
shared by all of a sample's tensors so paired tensors (image, cloudy view,
mask) stay aligned.

:func:`gather_batch` draws the indices and flips from an explicit
``torch.Generator`` on the cache's device and hands them to
:func:`gather_core`, which does the gather, the cast and the flips. The JAX
version does the same in XLA (``jnp.take``, ``jnp.where``), with no Pallas
kernel behind it; plain torch ops are the port here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["DeviceDataCache", "gather_batch", "gather_core"]


def gather_core(tensors: Dict[str, torch.Tensor], idx: torch.Tensor, do_h: torch.Tensor,
                do_v: torch.Tensor, compute_dtype=torch.float32,
                augment_flips: bool = True) -> Dict[str, torch.Tensor]:
    """Rows ``idx`` of every tensor, floats cast to ``compute_dtype``; where
    ``augment_flips``, sample ``i`` of every tensor with a spatial layout
    ([B, H, W] or [B, H, W, ...]) is flipped along W where ``do_h[i]`` and
    then along H where ``do_v[i]``."""
    out = {}
    b = idx.shape[0]
    for k, v in tensors.items():
        x = v.index_select(0, idx)
        if x.is_floating_point():
            x = x.to(compute_dtype)
        if augment_flips and x.dim() >= 3:
            # ndim 3 covers channel-less per-pixel pairs (masks stored
            # [N, H, W]): keying on >= 4 would leave them unflipped while
            # the image flips, misaligning the pair
            shape = (b,) + (1,) * (x.dim() - 1)
            x = torch.where(do_h.view(shape), x.flip(2), x)
            x = torch.where(do_v.view(shape), x.flip(1), x)
        out[k] = x
    return out


def gather_batch(tensors: Dict[str, torch.Tensor], generator: torch.Generator,
                 batch_size: int, compute_dtype=torch.float32,
                 augment_flips: bool = True) -> Dict[str, torch.Tensor]:
    """A random batch: indices uniform over the rows, and each sample's two
    flips with p = 0.5, drawn from ``generator`` on the tensors' device."""
    first = next(iter(tensors.values()))
    n, device = first.shape[0], first.device
    idx = torch.randint(0, n, (batch_size,), generator=generator, device=device)
    do_h = torch.rand(batch_size, generator=generator, device=device) < 0.5
    do_v = torch.rand(batch_size, generator=generator, device=device) < 0.5
    return gather_core(tensors, idx, do_h, do_v, compute_dtype, augment_flips)


class DeviceDataCache:
    """Hold a dict of [N, ...] arrays in device memory.

    :param tensors: dict of numpy arrays sharing the leading dim.
    :param device: where to hold them.
    :param store_dtype: dtype for float arrays on the device. Default
        float32 -- training numerics match the host loader exactly;
        ``torch.bfloat16`` halves the footprint and quantizes the stored
        images, an explicit opt-in. Integer and bool arrays keep their dtype.
    """

    def __init__(self, tensors: Dict[str, np.ndarray], device, store_dtype=torch.float32):
        ns = {k: len(v) for k, v in tensors.items()}
        if len(set(ns.values())) != 1:
            raise ValueError(f"mismatched leading dims: {ns}")
        self.n = next(iter(ns.values()))
        self.device = torch.device(device)
        self.tensors = {}
        for k, v in tensors.items():
            a = np.ascontiguousarray(v)
            t = torch.from_numpy(a if a.flags.writeable else a.copy())
            dt = store_dtype if t.is_floating_point() else t.dtype
            self.tensors[k] = t.to(self.device, dt)

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.tensors.values())

    def sample_batch(self, generator: torch.Generator, batch_size: int,
                     compute_dtype=torch.float32, augment_flips: bool = True):
        """:func:`gather_batch` over the cached tensors."""
        return gather_batch(self.tensors, generator, batch_size, compute_dtype, augment_flips)
