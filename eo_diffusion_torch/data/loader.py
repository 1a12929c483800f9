"""A minimal batching iterator over a map-style dataset (host-side numpy).

The sampling slice's counterpart of ``eo_diffusion_tpu/data/loader.py``:
deterministic epoch shuffles from a seed, optional random flips applied
jointly to every image-like key of an item, and stacking into dict batches.
The background prefetch and device feed come with the training slice.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from eo_diffusion_torch.data.datasets import Dataset

__all__ = ["DataLoader", "random_flips"]

_IMAGE_KEYS = ("image", "segmentation", "cond_image")


def random_flips(item: Dict[str, np.ndarray], rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Horizontal then vertical flip, each with p = 0.5, shared by the
    item's image-like keys (the reference's flip pair, data.py:66-67)."""
    keys = [k for k in _IMAGE_KEYS if k in item]
    out = dict(item)
    if rng.random() < 0.5:
        out.update({k: np.ascontiguousarray(out[k][:, ::-1]) for k in keys})
    if rng.random() < 0.5:
        out.update({k: np.ascontiguousarray(out[k][::-1]) for k in keys})
    return out


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, flips: bool = False):
        self.dataset, self.batch_size = dataset, batch_size
        self.shuffle, self.seed, self.drop_last, self.flips = shuffle, seed, drop_last, flips
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        idx = (np.random.default_rng(self.seed + self._epoch).permutation(n)
               if self.shuffle else np.arange(n))
        self._epoch += 1
        rng = np.random.default_rng((self.seed, self._epoch))
        for b in range(len(self)):
            items = [self.dataset[int(i)] for i in idx[b * self.batch_size:(b + 1) * self.batch_size]]
            if self.flips:
                items = [random_flips(it, rng) for it in items]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
