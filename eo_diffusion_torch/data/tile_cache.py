"""Cached-tile dataset: decode once, serve patches through the native sampler.

The port's copy of the JAX package's ``data/tile_cache.py``. Tiles (from any
source -- Inria TIFFs, Sentinel-2 CMC .npy, synthetic) are decoded once into
a contiguous uint8 stack, then every ``__getitem__``/``get_batch`` is one
GIL-free native extraction (window copy + normalize + flips fused;
``csrc/patch_sampler.cc``). It replaces the reference's eager
``make_patches`` (data_load.py:159-207), which materialized every patch of
every tile up front (O(dataset) RAM).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from eo_diffusion_torch.data.datasets import Dataset
from eo_diffusion_torch.data.native import extract_patches
from eo_diffusion_torch.data.patches import num_windows, window_index

__all__ = ["CachedTileDataset"]


class CachedTileDataset(Dataset):
    """Serve (image, segmentation?) patches from a uint8 tile stack.

    :param tiles: [n_tiles, H, W, C] uint8 image tiles.
    :param masks: optional [n_tiles, H, W, Cm] uint8 masks, windowed jointly.
    :param labels: optional per-tile int class labels.
    :param data_range: (0,1) or (-1,1); the native sampler fuses the scaling.
    :param augment_flips: random h/v flips fused into extraction (train mode).
    """

    def __init__(
        self,
        tiles: np.ndarray,
        masks: Optional[np.ndarray] = None,
        labels: Optional[Sequence[int]] = None,
        size: int = 64,
        overlap: float = 0.5,
        data_range: Tuple[float, float] = (0.0, 1.0),
        augment_flips: bool = False,
        seed: int = 0,
    ):
        assert tiles.dtype == np.uint8 and tiles.ndim == 4, (tiles.dtype, tiles.shape)
        self.tiles = np.ascontiguousarray(tiles)
        self.masks = np.ascontiguousarray(masks) if masks is not None else None
        self.labels = None if labels is None else np.asarray(labels, np.int32)
        self.size = size
        self.step = max(int((1 - overlap) * size), 1)
        self.data_range = data_range
        self.augment_flips = augment_flips
        self._rng = np.random.default_rng(seed)

        h, w = tiles.shape[1:3]
        n_i, n_j = num_windows((h, w), size, self.step)
        self.windows_per_tile = n_i * n_j
        self.n_j = n_j

        lo, hi = data_range
        self._scale = (hi - lo) / 255.0
        self._bias = lo

    def __len__(self):
        return self.tiles.shape[0] * self.windows_per_tile

    def _job(self, i: int, flip: int) -> np.ndarray:
        ti, p = divmod(i, self.windows_per_tile)
        r, c = window_index(p, self.tiles.shape[1:3], self.size, self.step, self.n_j)
        return np.asarray([ti, r, c, flip], np.int64)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        flip = int(self._rng.integers(0, 4)) if self.augment_flips else 0
        job = self._job(int(i), flip)[None]
        out = {"image": extract_patches(self.tiles, job, self.size, self._scale, self._bias)[0]}
        if self.masks is not None:
            out["segmentation"] = extract_patches(self.masks, job, self.size, 1.0 / 255.0)[0]
        if self.labels is not None:
            out["class"] = self.labels[job[0, 0]]
        return out

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Vectorized batch extraction -- one native call for all patches."""
        flips = (
            self._rng.integers(0, 4, len(indices))
            if self.augment_flips
            else np.zeros(len(indices), np.int64)
        )
        jobs = np.stack([self._job(int(i), int(f)) for i, f in zip(indices, flips)])
        out = {"image": extract_patches(self.tiles, jobs, self.size, self._scale, self._bias)}
        if self.masks is not None:
            out["segmentation"] = extract_patches(self.masks, jobs, self.size, 1.0 / 255.0)
        if self.labels is not None:
            out["class"] = self.labels[jobs[:, 0]]
        return out
