"""Image grid saving + range handling (numpy + PIL).

The port's own copy of ``eo_diffusion_tpu/utils/images.py``; replaces the
reference's torchvision ``save_image`` usage (inference.py:142-150)."""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["to_uint8", "make_grid", "save_image_grid", "adjust_brightness", "rescale_to_unit"]


def rescale_to_unit(images: np.ndarray, data_range: Tuple[float, float]) -> np.ndarray:
    """Map images from their dataset range to [0,1].

    Explicit-range version of the reference's min()-based heuristic
    (train.py:150, inference.py:128): samples from models trained on [-1,1]
    data are shifted, [0,1] data is clipped.
    """
    lo, hi = data_range
    if lo < 0:
        images = (images + 1.0) / 2.0
    return np.clip(images, 0.0, 1.0)


def adjust_brightness(images: np.ndarray, factor: float) -> np.ndarray:
    """Brightness scale like torchvision F.adjust_brightness (train.py:151)."""
    return np.clip(images * factor, 0.0, 1.0)


def to_uint8(images: np.ndarray) -> np.ndarray:
    return (np.clip(images, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: Optional[int] = None, pad: int = 2) -> np.ndarray:
    """[N,H,W,C] -> single [H',W',C] grid image (torchvision-style)."""
    n, h, w, c = images.shape
    nrow = nrow or int(math.sqrt(n)) or 1
    ncol = -(-n // nrow)
    grid = np.zeros((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c), images.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[
            pad + r * (h + pad) : pad + r * (h + pad) + h,
            pad + col * (w + pad) : pad + col * (w + pad) + w,
        ] = images[i]
    return grid


def save_image_grid(images, path: str, nrow: Optional[int] = None,
                    data_range: Tuple[float, float] = (0.0, 1.0)) -> None:
    """Save an [N,H,W,C] batch as one PNG grid."""
    from PIL import Image

    images = np.asarray(images, np.float32)
    if images.ndim == 3:
        images = images[None]
    images = rescale_to_unit(images, data_range)
    grid = to_uint8(make_grid(images, nrow))
    if grid.shape[-1] == 1:
        grid = grid[:, :, 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path)
