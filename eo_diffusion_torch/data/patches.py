"""Patch-extraction math for large EO tiles (pure numpy, zero-copy views).

The port's copy of the JAX package's ``data/patches.py``.

Re-design of the reference's two patchification styles:

* eager grid patchify with uniform subsampling (reference ``make_patches``,
  ``data_utils/data_load.py:159-207``, built on the ``patchify`` lib) --
  here done with stride tricks, so the patch "extraction" is a view and only
  the selected subset is materialized;
* lazy per-index window addressing (reference ``CloudMaskDataset.__getitem__``
  ``data_load.py:443-445`` and ``SARWakeDataset`` ``data_load.py:521-533``)
  -- exposed as :func:`window_index` / :func:`num_windows`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["grid_patches", "subsample_patches", "num_windows", "window_index"]


def grid_patches(image: np.ndarray, size: int, step: int) -> np.ndarray:
    """All size x size patches of an HWC image at the given stride.

    Returns a zero-copy [nI, nJ, size, size, C] strided view (row-major patch
    grid, same enumeration order as the reference's patchify call).
    """
    h, w, c = image.shape
    n_i = (h - size) // step + 1
    n_j = (w - size) // step + 1
    sh, sw, sc = image.strides
    return np.lib.stride_tricks.as_strided(
        image,
        shape=(n_i, n_j, size, size, c),
        strides=(sh * step, sw * step, sh, sw, sc),
        writeable=False,
    )


def subsample_patches(patches: np.ndarray, num_patches: int) -> np.ndarray:
    """Uniformly subsample a flattened patch grid.

    Mirrors the reference's jump-selection (``data_load.py:182-184``):
    ``n = min(num, total)``, ``jump = total // num``, take every jump-th.
    Materializes only the selected patches.
    """
    flat = patches.reshape((-1,) + patches.shape[2:])
    dim = flat.shape[0]
    n = min(num_patches, dim)
    jump = dim // num_patches if num_patches else 0
    sel = flat[: n * jump : jump] if jump > 0 else flat[:n]
    return np.ascontiguousarray(sel)


def num_windows(orig: Tuple[int, int], size: int, step: int, overhang: bool = False) -> Tuple[int, int]:
    """Window-grid shape for lazy indexing.

    ``overhang=False`` matches CloudMaskDataset (data_load.py:405);
    ``overhang=True`` adds the extra clamped edge window of SARWakeDataset
    (data_load.py:510-511).
    """
    n_i = (orig[0] - size) // step + 1
    n_j = (orig[1] - size) // step + 1
    if overhang:
        n_i += int(orig[0] > size)
        n_j += int(orig[1] > size)
    return max(n_i, 1), max(n_j, 1)


def window_index(
    patch_idx: int,
    orig: Tuple[int, int],
    size: int,
    step: int,
    n_j: int,
    clamp: bool = False,
) -> Tuple[int, int]:
    """(row, col) pixel offsets of the ``patch_idx``-th window.

    ``clamp=True`` clips the window inside the tile like SARWake
    (data_load.py:531); otherwise plain grid addressing like CloudMask
    (data_load.py:443).
    """
    i = (patch_idx // n_j) * step
    j = (patch_idx % n_j) * step
    if clamp:
        i = max(min(i, orig[0] - size - 1), 0)
        j = max(min(j, orig[1] - size - 1), 0)
    return i, j
