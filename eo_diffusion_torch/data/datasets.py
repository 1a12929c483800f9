"""Synthetic EO dataset (host-side numpy, NHWC) for the port's data-free path.

The port's own copy of the ``Dataset`` protocol, ``Subset``,
``train_val_split`` and ``SyntheticEO`` from
``eo_diffusion_tpu/data/datasets.py`` (numpy only), so ``--dataset
synthetic`` yields the same cloudy/clear pairs at any size. Every item is a
dict with "image" [H,W,C] and optionally "segmentation" [H,W,1] /
"cond_image" [H,W,C] / "class".
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["Dataset", "Subset", "train_val_split", "SyntheticEO"]


class Dataset:
    """Minimal map-style dataset protocol."""

    #: value range of "image" entries: (0, 1) or (-1, 1)
    data_range: Tuple[float, float] = (0.0, 1.0)

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset, self.indices = dataset, list(indices)
        self.data_range = dataset.data_range

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def train_val_split(dataset: Dataset, val_fraction: float = 0.15, seed: int = 4097):
    """Deterministic random train/val split (replaces the reference's
    ``torch.random_split(generator=manual_seed(4097))``, data.py:74)."""
    n = len(dataset)
    perm = np.random.default_rng(seed).permutation(n)
    n_val = int(round(val_fraction * n))
    return Subset(dataset, perm[n_val:]), Subset(dataset, perm[:n_val])


# ---------------------------------------------------------------------------
# Synthetic EO data (no reference equivalent; enables data-free operation)
# ---------------------------------------------------------------------------


class SyntheticEO(Dataset):
    """Procedural EO-like imagery: smooth 'terrain' + blobby 'cloud' masks.

    Deterministic per index. Stands in for any of the real datasets in
    tests, benchmarks and the CLIs (``--dataset synthetic``).
    """

    def __init__(self, size: int = 64, length: int = 1024, channels: int = 3,
                 num_classes: int = 5, with_mask: bool = True, seed: int = 0,
                 data_range: Tuple[float, float] = (0.0, 1.0),
                 with_cond_image: bool = False,
                 class_correlated: bool = False,
                 texture: float = 0.0):
        self.size, self.length, self.channels = size, length, channels
        self.num_classes, self.with_mask, self.seed = num_classes, with_mask, seed
        self.data_range = data_range
        # opt-in high-frequency content (default off so recorded capstone
        # statistics stay stable): sharp level-set contour lines of the
        # terrain field. The edges are a deterministic function of the
        # low-frequency structure, so they are inferable from a downsampled
        # view — the fair super-resolution fixture (bicubic blurs them, a
        # learned SR stage can re-sharpen them; tools/capstone_sr.py
        # --texture). Strength in [0, 1] darkens the contour pixels.
        self.texture = float(texture)
        # cloud-removal fixture: emit a synthetic cloudy view as "cond_image"
        # (stands in for the SEN12MS-CR cloudy S2 band, sen12ms_cr.py)
        self.with_cond_image = with_cond_image
        # opt-in (default off so recorded capstone statistics stay stable):
        # give each class a distinct per-channel gain signature so class
        # labels carry learnable visual signal -- the fixture for
        # classifier-free-guidance quality evaluation (tools/capstone_cfg.py)
        self.class_correlated = class_correlated

    def __len__(self):
        return self.length

    def _field(self, rng, scale: float) -> np.ndarray:
        """Smooth random field via low-res noise + bilinear upsample."""
        low = max(int(self.size / scale), 2)
        coarse = rng.normal(size=(low, low)).astype(np.float32)
        ry = np.linspace(0, low - 1, self.size)
        y0 = np.floor(ry).astype(int)
        y1 = np.minimum(y0 + 1, low - 1)
        wy = (ry - y0).astype(np.float32)
        rows = coarse[y0] * (1 - wy[:, None]) + coarse[y1] * wy[:, None]
        cols = rows[:, y0] * (1 - wy[None, :]) + rows[:, y1] * wy[None, :]
        return cols

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        base = self._field(rng, 8.0)
        img = np.stack(
            [base * rng.uniform(0.3, 1.0) + 0.15 * self._field(rng, 4.0)
             for _ in range(self.channels)],
            axis=-1,
        )
        img = (img - img.min()) / max(float(np.ptp(img)), 1e-6)
        if self.texture > 0:
            # quantize the terrain into bands; band boundaries are 1-2 px
            # sharp contour lines (see __init__ texture doc)
            band = (base - base.min()) / max(float(np.ptp(base)), 1e-6)
            q = np.floor(band * 7.999).astype(np.int32)
            edge = np.zeros_like(band, dtype=bool)
            edge[:-1, :] |= q[:-1, :] != q[1:, :]
            edge[:, :-1] |= q[:, :-1] != q[:, 1:]
            img = img * (1.0 - self.texture * 0.7 * edge[:, :, None])
        label = i % self.num_classes
        if self.class_correlated:
            # class k emphasizes channel k%C and damps the others; gains are
            # strong enough to be a learnable, measurable signature
            gains = np.full((self.channels,), 0.45, np.float32)
            gains[label % self.channels] = 1.0
            img = img * gains[None, None, :]
        lo, hi = self.data_range
        img = (img * (hi - lo) + lo).astype(np.float32)
        out = {"image": img, "class": np.int32(label)}
        if self.with_mask or self.with_cond_image:
            cloud = self._field(rng, 6.0)
            thr = np.quantile(cloud, rng.uniform(0.55, 0.8))
            if self.with_mask:
                out["segmentation"] = (cloud > thr).astype(np.float32)[:, :, None]
            if self.with_cond_image:
                # soft cloud alpha over the clear image -> bright "cloudy" view
                alpha = (1.0 / (1.0 + np.exp(-(cloud - thr) * 8.0))).astype(np.float32)
                out["cond_image"] = (
                    img * (1.0 - alpha[:, :, None]) + hi * alpha[:, :, None]
                ).astype(np.float32)
        return out
