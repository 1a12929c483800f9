"""EO dataset classes (host-side numpy, NHWC) of the port.

The port's own copy of ``eo_diffusion_tpu``'s ``data/datasets.py`` (numpy
only): the ``Dataset`` protocol, ``Subset``, ``train_val_split``, the
synthetic fixtures and the real EO datasets (MNIST, CIFAR-10, Inria, the
Sentinel-2 Cloud Mask Catalogue, OSCD, SAR wakes, EuroSAT) with the
reference's on-disk layouts and filtering (``data_utils/data_load.py``).
PIL is imported only by the datasets that decode PNG/JPEG/8-bit TIFF files,
and the CSV indexes are read with the standard library's ``csv`` (the rows
``pandas.read_csv`` gives, compared as numbers where they parse as numbers).
Every item is a dict with "image" [H,W,C] and optionally "segmentation"
[H,W,1] / "cond_image" [H,W,C] / "class".
"""

from __future__ import annotations

import csv
import glob
import gzip
import math
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from eo_diffusion_torch.data.patches import (
    grid_patches,
    num_windows,
    subsample_patches,
    window_index,
)

__all__ = [
    "Dataset",
    "SyntheticEO",
    "SyntheticEOHard",
    "MNISTDataset",
    "CIFAR10Dataset",
    "InriaDataset",
    "CloudMaskDataset",
    "OSCDDataset",
    "SARWakeDataset",
    "EuroSATDataset",
    "get_metadata",
    "class_names",
    "train_val_split",
    "Subset",
]


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


def _open_image(path: str, mode: str = "RGB") -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert(mode), np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr

def _read_csv(path: str) -> List[Dict[str, str]]:
    """The rows of a CSV file with a header line, as dicts of strings."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _number(cell: str) -> float:
    """A CSV cell as pandas compares it: its number, or NaN (equal to
    nothing, ordered against nothing) where it is empty or not numeric."""
    try:
        return float(cell)
    except ValueError:
        return math.nan


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


class SyntheticEOHard(SyntheticEO):
    """Multi-modal, textured, class-diverse synthetic EO fixture.

    The plain SyntheticEO distribution (one smooth-field mode) is easy
    enough that small models reach an extractor's noise floor quickly. Here
    each class is a *different generator* with high-frequency content, so
    both coverage (5 visually distinct modes) and fidelity (sharp edges,
    oriented texture, speckle) have room to fail.

    Classes (EO archetypes):
      0 urban     — rectilinear blocks of varying tone + dark street grid
      1 cropland  — oriented stripe fields (random angle/frequency/phase)
      2 forest    — multi-scale speckle texture over a smooth canopy field
      3 coast     — smooth water gradient / bright land split by a sharp
                    shoreline level-set, waves near the shore
      4 mountains — ridged terrain (folded field) with directional shading

    Same dict/API surface as SyntheticEO (image / class / segmentation /
    cond_image, ``data_range``), deterministic per index. Masks and cloudy
    cond views reuse the parent's cloud generator so cloud-removal capstones
    can switch fixtures with one flag (``--dataset synthetic_hard``).
    """

    def _color(self, rng, img01, tints):
        """Colorize a [H,W] field with per-channel affine tints + jitter."""
        chans = []
        for c in range(self.channels):
            lo, hi = tints[c % len(tints)]
            gain = rng.uniform(0.85, 1.15)
            chans.append((lo + (hi - lo) * img01) * gain)
        return np.clip(np.stack(chans, axis=-1), 0.0, 1.0)

    def _urban(self, rng):
        s = self.size
        img = np.zeros((s, s), np.float32)
        # random rectilinear partition: blocks of distinct tone
        hi_n = max(min(7, (s - 4) // 2 + 1), 4)  # small sizes still split
        nx, ny = rng.integers(3, hi_n), rng.integers(3, hi_n)
        xs = np.sort(np.r_[0, rng.choice(np.arange(2, s - 2), nx - 1,
                                         replace=False), s])
        ys = np.sort(np.r_[0, rng.choice(np.arange(2, s - 2), ny - 1,
                                         replace=False), s])
        for i in range(len(xs) - 1):
            for j in range(len(ys) - 1):
                img[xs[i]:xs[i + 1], ys[j]:ys[j + 1]] = rng.uniform(0.35, 0.95)
        # dark street grid on the partition lines (1px, high frequency)
        img[xs[1:-1], :] = 0.12
        img[:, ys[1:-1]] = 0.12
        return self._color(rng, img, [(0.05, 0.95), (0.05, 0.90), (0.08, 0.88)])

    def _cropland(self, rng):
        s = self.size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(0.25, 0.9)
        phase = rng.uniform(0, 2 * np.pi)
        stripes = np.sin((xx * np.cos(theta) + yy * np.sin(theta)) * freq
                         + phase)
        # square the profile into plateaus + sharp furrow transitions
        img = 0.5 + 0.45 * np.tanh(stripes * rng.uniform(2.0, 6.0))
        img = img * (0.75 + 0.25 * self._norm01(self._field(rng, 8.0)))
        return self._color(rng, img, [(0.15, 0.75), (0.25, 0.85), (0.05, 0.45)])

    def _forest(self, rng):
        canopy = self._norm01(self._field(rng, 8.0))
        # speckle: white noise shaped by two octaves (real high frequency)
        speck = (0.6 * rng.normal(size=canopy.shape)
                 + 0.4 * self._field(rng, 2.0)).astype(np.float32)
        img = np.clip(0.35 + 0.4 * canopy + 0.18 * speck, 0.0, 1.0)
        return self._color(rng, img, [(0.02, 0.35), (0.10, 0.70), (0.02, 0.30)])

    def _coast(self, rng):
        shore = self._field(rng, 10.0)
        level = np.quantile(shore, rng.uniform(0.35, 0.65))
        water = shore <= level
        s = self.size
        yy = np.mgrid[0:s, 0:s][0].astype(np.float32) / s
        img = np.where(water, 0.18 + 0.12 * yy,
                       0.55 + 0.35 * self._norm01(self._field(rng, 6.0)))
        # waves: ripples confined to water near the shoreline
        d = np.abs(shore - level)
        ripple = 0.10 * np.sin(d * rng.uniform(60, 120)) * np.exp(-d * 8.0)
        img = np.clip(img + np.where(water, ripple, 0.0), 0.0, 1.0)
        rgb = self._color(rng, img, [(0.05, 0.80), (0.15, 0.80), (0.30, 0.70)])
        # water leans blue: damp all-but-last channels where water
        rgb[..., :-1] *= np.where(water, 0.55, 1.0)[..., None]
        return np.clip(rgb, 0.0, 1.0)

    def _mountains(self, rng):
        f = self._field(rng, 10.0) + 0.5 * self._field(rng, 4.0)
        ridged = 1.0 - np.abs(f) / max(float(np.abs(f).max()), 1e-6)
        # directional shading = derivative along a random light azimuth
        gx = np.diff(ridged, axis=0, append=ridged[-1:, :])
        gy = np.diff(ridged, axis=1, append=ridged[:, -1:])
        az = rng.uniform(0, 2 * np.pi)
        shade = np.cos(az) * gx + np.sin(az) * gy
        img = np.clip(0.25 + 0.55 * ridged + 6.0 * shade, 0.0, 1.0)
        return self._color(rng, img, [(0.15, 0.85), (0.12, 0.70), (0.10, 0.60)])

    @staticmethod
    def _norm01(x):
        return (x - x.min()) / max(float(np.ptp(x)), 1e-6)

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        label = i % self.num_classes
        gen = [self._urban, self._cropland, self._forest, self._coast,
               self._mountains][label % 5]
        img = gen(rng).astype(np.float32)
        lo, hi = self.data_range
        out = {"image": (img * (hi - lo) + lo).astype(np.float32),
               "class": np.int32(label)}
        if self.with_mask or self.with_cond_image:
            cloud = self._field(rng, 6.0)
            thr = np.quantile(cloud, rng.uniform(0.55, 0.8))
            if self.with_mask:
                out["segmentation"] = (cloud > thr).astype(np.float32)[:, :, None]
            if self.with_cond_image:
                alpha = (1.0 / (1.0 + np.exp(-(cloud - thr) * 8.0))).astype(np.float32)
                out["cond_image"] = (
                    out["image"] * (1.0 - alpha[:, :, None]) + hi * alpha[:, :, None]
                ).astype(np.float32)
        return out


# ---------------------------------------------------------------------------
# MNIST / CIFAR10 (reference data.py:24-62, data_load.py:384-397)
# ---------------------------------------------------------------------------


class MNISTDataset(Dataset):
    """MNIST from raw IDX files; output in [-1,1] like the reference's
    Normalize([0.5],[0.5]) preprocessing (data.py:26-28)."""

    data_range = (-1.0, 1.0)

    def __init__(self, root: str, train: bool = True, image_size: int = 28):
        kind = "train" if train else "t10k"
        self.images = self._read_idx(root, f"{kind}-images-idx3-ubyte")
        self.labels = self._read_idx(root, f"{kind}-labels-idx1-ubyte")
        self.image_size = image_size

    @staticmethod
    def _read_idx(root: str, name: str) -> np.ndarray:
        path = os.path.join(root, name)
        opener = open
        if not os.path.exists(path):
            path += ".gz"
            opener = gzip.open
        with opener(path, "rb") as f:
            magic = struct.unpack(">HBB", f.read(4))
            ndim = magic[2]
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return np.frombuffer(f.read(), np.uint8).reshape(dims)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = self.images[i].astype(np.float32) / 255.0
        if self.image_size != img.shape[0]:
            from eo_diffusion_torch.data.transforms import Resize

            img = Resize(self.image_size)(img[:, :, None], None)[:, :, 0]
        return {
            "image": (img[:, :, None] * 2.0 - 1.0).astype(np.float32),
            "class": np.int32(self.labels[i]),
        }


class CIFAR10Dataset(Dataset):
    """CIFAR-10 from the python-pickle batches; [0,1] range like the
    reference's ToTensor-only pipeline (data.py:44-48)."""

    data_range = (0.0, 1.0)

    def __init__(self, root: str, train: bool = True):
        import pickle

        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        xs, ys = [], []
        base = os.path.join(root, "cifar-10-batches-py")
        for fn in files:
            with open(os.path.join(base, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = np.asarray(ys, np.int32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {
            "image": self.images[i].astype(np.float32) / 255.0,
            "class": self.labels[i],
        }


# ---------------------------------------------------------------------------
# Inria Aerial Image Labeling (reference data_load.py:212-316)
# ---------------------------------------------------------------------------

INRIA_CLASSES = {"austin": 0, "chicago": 1, "kitsap": 2, "tyrol": 3, "vienna": 4}


class InriaDataset(Dataset):
    """5000x5000 aerial tiles + building-mask GTs, patchified.

    Same layout/semantics as the reference (``data_load.py:212-316``): globs
    ``train/images/*.tif`` + ``train/gt/*.tif``, optional ``length``-limited
    uniform tile subsampling (data_load.py:236-238), city->class labels from
    filename prefixes (data_load.py:252, 289), ``num_patches`` uniformly
    subsampled patches per tile at stride ``(1-overlap)*size``
    (make_patches, data_load.py:159-185).

    Unlike the reference's eager full-tile materialization
    (data_load.py:257-258), tiles are memoized lazily per worker and patches
    are strided views -- O(tile) memory instead of O(dataset).
    """

    data_range = (0.0, 1.0)

    def __init__(self, path: str, size: int = 64, patch_overlap: float = 0.5,
                 num_patches: int = 200, length: int = 0, mask_threshold: float = 0.5):
        self.images = sorted(glob.glob(os.path.join(path, "train/images", "*tif")))
        self.masks = sorted(glob.glob(os.path.join(path, "train/gt", "*tif")))
        assert len(self.images) == len(self.masks), (len(self.images), len(self.masks))
        if length > 0 and length < len(self.images):
            jump = len(self.images) // length
            self.images = self.images[: length * jump : jump]
            self.masks = self.masks[: length * jump : jump]
        self.size = size
        self.step = max(int((1 - patch_overlap) * size), 1)
        self.mask_threshold = mask_threshold
        # patches per tile (capped like data_load.py:168)
        if self.images:
            probe = _open_image(self.images[0])
            grid = grid_patches(probe, size, self.step)
            total = grid.shape[0] * grid.shape[1]
        else:
            total = 0
        self.n_patches = min(num_patches, total) if total else 0
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self):
        return len(self.images) * self.n_patches

    def _tile(self, n: int):
        if n not in self._cache:
            self._cache.clear()  # keep at most one tile per worker
            img = _open_image(self.images[n], "RGB")
            msk = _open_image(self.masks[n], "L")
            self._cache[n] = (img, msk)
        return self._cache[n]

    def class_label(self, tile_idx: int) -> int:
        name = os.path.basename(self.images[tile_idx])
        for city, lbl in INRIA_CLASSES.items():
            if name.startswith(city[:3]):
                return lbl
        return 0

    def __getitem__(self, i):
        tile_idx, p = divmod(i, self.n_patches)
        img, msk = self._tile(tile_idx)
        # uniform subsample over the flattened grid (data_load.py:182-184)
        grid = grid_patches(img, self.size, self.step)
        mgrid = grid_patches(msk, self.size, self.step)
        total = grid.shape[0] * grid.shape[1]
        jump = max(total // self.n_patches, 1)
        flat_idx = p * jump
        gi, gj = divmod(flat_idx, grid.shape[1])
        patch = np.ascontiguousarray(grid[gi, gj])
        mpatch = np.ascontiguousarray(mgrid[gi, gj])
        mpatch = (mpatch >= self.mask_threshold).astype(np.float32)
        return {
            "image": patch,
            "segmentation": mpatch,
            "class": np.int32(self.class_label(tile_idx)),
        }


# ---------------------------------------------------------------------------
# Sentinel-2 Cloud Mask Catalogue (reference data_load.py:400-468)
# ---------------------------------------------------------------------------


class CloudMaskDataset(Dataset):
    """Sentinel-2 CMC subscenes: 1022x1022 .npy tiles + mask .npy, filtered by
    the classification-tags CSV, windowed into patches.

    Filtering semantics follow data_load.py:410-419: snow/ice == 0,
    clear_percent >= percents[0], cloud_percent >= percents[1], and the tile
    tagged with at least one of ``classes``. Bands [3,2,1] -> RGB, clipped to
    [0,1] (data_load.py:437-438); mask channel 1 (data_load.py:439).
    """

    data_range = (0.0, 1.0)

    def __init__(self, root: str, classes: Sequence[str] = ("agricultural", "urban/developed", "hills/mountains"),
                 percents: Sequence[float] = (50, 25, 70), size: int = 64,
                 num_patches: int = 200, ratio: float = 0.0, length: int = 3):
        self.img_path = os.path.join(root, "subscenes")
        self.mask_path = os.path.join(root, "masks")
        rows = _read_csv(os.path.join(root, "classification_tags.csv"))
        names = [
            r["scene"] for r in rows
            if _number(r["snow/ice"]) == 0
            and _number(r["clear_percent"]) >= percents[0]
            and _number(r["cloud_percent"]) >= percents[1]
            and any(_number(r[cls]) == 1 for cls in classes)
        ]
        self.names = names[:length] if 0 < length < len(names) else names

        self.size = size
        self.orig = (1022, 1022)
        self.step = max(int((1 - ratio) * size), 1)
        n_i, n_j = num_windows(self.orig, size, self.step)
        self.n_j = n_j
        self.num_patches = min(num_patches, n_i * n_j)
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self):
        return len(self.names) * self.num_patches

    def _tile(self, n: int):
        if n not in self._cache:
            self._cache.clear()
            img = np.load(os.path.join(self.img_path, self.names[n] + ".npy"))
            msk = np.load(os.path.join(self.mask_path, self.names[n] + ".npy"))
            img = np.clip(img[..., [3, 2, 1]], 0, 1).astype(np.float32)
            msk = msk[..., 1:2].astype(np.float32)  # channel 1 (data_load.py:439)
            self._cache[n] = (img, msk)
        return self._cache[n]

    def __getitem__(self, i):
        n, p = divmod(i, self.num_patches)
        img, msk = self._tile(n)
        ii, jj = window_index(p, self.orig, self.size, self.step, self.n_j)
        sl = np.s_[ii : ii + self.size, jj : jj + self.size]
        return {
            "image": np.ascontiguousarray(img[sl]),
            "segmentation": np.ascontiguousarray(msk[sl]),
        }


# ---------------------------------------------------------------------------
# OSCD change detection (reference data_load.py:470-501)
# ---------------------------------------------------------------------------


class OSCDDataset(Dataset):
    """Onera change-detection patches: paired t1/t2 RGB rectified crops +
    change labels, real or synthetic ("fake") directory layouts.

    Filename patterns follow data_load.py:479-481: ``*imgs_2_rect-rgb*`` (t2,
    the "image"), ``*imgs_1_rect-rgb*`` (t1), ``*lbl*`` (change mask). The
    reference getitem returns (t2, label); ``return_pair=True`` additionally
    yields t1 as "image2" for change-pair generation.
    """

    data_range = (0.0, 1.0)

    def __init__(self, path: str, length: Optional[int] = None, return_pair: bool = False):
        self.img_names = sorted(glob.glob(os.path.join(path, "*imgs_2_rect-rgb*")))
        self.gt_names = sorted(glob.glob(os.path.join(path, "*imgs_1_rect-rgb*")))
        self.label_names = sorted(glob.glob(os.path.join(path, "*lbl*")))
        if length is not None:
            self.img_names = self.img_names[:length]
            self.label_names = self.label_names[:length]
        self.return_pair = return_pair

    @staticmethod
    def fake_dirname(base: str, pw=64, ph=64, sw=32, sh=32, mnh=10, mnw=10,
                     mxw=50, mxh=50, clip=0.3, mult=1) -> str:
        """Synthetic-OSCD directory naming scheme (data_load.py:473-474)."""
        name = f"OSCD_p_dataset_{pw}_{ph}_{sw}_{sh}_{mnw}_{mnh}_{mxw}_{mxh}_{clip}"
        if mult > 1:
            name += f"_{mult}"
        return os.path.join(base, name)

    def __len__(self):
        return len(self.img_names)

    def __getitem__(self, n):
        img = _open_image(self.img_names[n], "RGB")
        label = _open_image(self.label_names[n], "L")
        out = {"image": img, "segmentation": label}
        if self.return_pair and n < len(self.gt_names):
            out["image2"] = _open_image(self.gt_names[n], "RGB")
        return out


# ---------------------------------------------------------------------------
# SAR ship-wake tiles (reference data_load.py:503-555)
# ---------------------------------------------------------------------------


class SARWakeDataset(Dataset):
    """Variable-size grayscale SAR tiles windowed into patches with per-tile
    patch-count bookkeeping (cumulative index -> (tile, window), mirroring
    data_load.py:515-533 including the clamped edge windows)."""

    data_range = (0.0, 1.0)

    def __init__(self, root: str, mode: str = "train", size: int = 64,
                 num_patches: int = 200, ratio: float = 0.5, length: int = 1):
        sub = "train2017" if mode == "train" else "val2017"
        self.root = os.path.join(root, sub)
        index = "train_csv.csv" if mode == "train" else "val_csv.csv"
        rows = _read_csv(os.path.join(self.root, index))
        self.names = [r["filename"] for r in rows][:length]
        self.size = size
        self.step = max(int((1 - ratio) * size), 1)

        self.counts: List[int] = []
        self.sizes: List[Tuple[int, int]] = []
        for name in self.names:
            from PIL import Image

            with Image.open(os.path.join(self.root, name)) as im:
                w, h = im.size
            n_i, n_j = num_windows((h, w), size, self.step, overhang=True)
            self.counts.append(min(num_patches, n_i * n_j))
            self.sizes.append((h, w))
        self.cum = np.cumsum(self.counts)

    def __len__(self):
        return int(self.cum[-1]) if len(self.cum) else 0

    def __getitem__(self, i):
        n = int(np.searchsorted(self.cum, i, side="right"))
        p = i - (self.cum[n - 1] if n else 0)
        tile = _open_image(os.path.join(self.root, self.names[n]), "L")
        h, w = tile.shape[:2]
        _, n_j = num_windows((h, w), self.size, self.step, overhang=True)
        ii, jj = window_index(int(p), (h, w), self.size, self.step, n_j, clamp=True)
        return {"image": np.ascontiguousarray(tile[ii : ii + self.size, jj : jj + self.size])}


# ---------------------------------------------------------------------------
# EuroSAT (reference data_load.py:557-586)
# ---------------------------------------------------------------------------


class EuroSATDataset(Dataset):
    """EuroSAT RGB folder dataset; class label from the folder name (the
    reference drops the label, data_load.py:584; we keep it)."""

    data_range = (0.0, 1.0)

    def __init__(self, root: str):
        self.folders = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.files: List[str] = []
        self.labels: List[int] = []
        for ci, folder in enumerate(self.folders):
            for f in sorted(glob.glob(os.path.join(root, folder, "*.jpg"))):
                self.files.append(f)
                self.labels.append(ci)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, n):
        return {
            "image": _open_image(self.files[n], "RGB"),
            "class": np.int32(self.labels[n]),
        }


# ---------------------------------------------------------------------------
# Metadata registry (reference data.py:125-218)
# ---------------------------------------------------------------------------

_METADATA = {
    "mnist": dict(image_size=28, num_classes=10, train_images=60000, val_images=10000, num_channels=1),
    "mnist_m": dict(image_size=28, num_classes=10, train_images=60000, val_images=10000, num_channels=3),
    "cifar10": dict(image_size=32, num_classes=10, train_images=50000, val_images=10000, num_channels=3),
    "melanoma": dict(image_size=64, num_classes=2, train_images=33126, val_images=0, num_channels=3),
    "afhq": dict(image_size=64, num_classes=3, train_images=14630, val_images=1500, num_channels=3),
    "celeba": dict(image_size=64, num_classes=4, train_images=109036, val_images=12376, num_channels=3),
    "cars": dict(image_size=64, num_classes=196, train_images=8144, val_images=8041, num_channels=3),
    "flowers": dict(image_size=64, num_classes=102, train_images=2040, val_images=6149, num_channels=3),
    "gtsrb": dict(image_size=32, num_classes=43, train_images=39252, val_images=12631, num_channels=3),
    # EO datasets (new entries)
    "eurosat": dict(image_size=64, num_classes=10, train_images=27000, val_images=0, num_channels=3),
    "inria": dict(image_size=64, num_classes=5, train_images=0, val_images=0, num_channels=3),
    "clouds": dict(image_size=64, num_classes=0, train_images=0, val_images=0, num_channels=3),
    "oscd": dict(image_size=64, num_classes=0, train_images=0, val_images=0, num_channels=3),
    "sarwake": dict(image_size=64, num_classes=0, train_images=0, val_images=0, num_channels=1),
    "synthetic": dict(image_size=64, num_classes=5, train_images=1024, val_images=128, num_channels=3),
    "synthetic_hard": dict(image_size=64, num_classes=5, train_images=1024, val_images=128, num_channels=3),
}


def get_metadata(name: str) -> dict:
    """Dataset metadata registry (reference ``get_metadata``, data.py:125-218)."""
    if name not in _METADATA:
        raise ValueError(f"{name} dataset not supported!")
    return dict(_METADATA[name])


_CLASS_NAMES = {
    "inria": tuple(INRIA_CLASSES),  # city vocab (reference data_load.py:246-252)
    "eurosat": ("AnnualCrop", "Forest", "HerbaceousVegetation", "Highway",
                "Industrial", "Pasture", "PermanentCrop", "Residential",
                "River", "SeaLake"),
    "cifar10": ("airplane", "automobile", "bird", "cat", "deer",
                "dog", "frog", "horse", "ship", "truck"),
    "mnist": tuple(str(i) for i in range(10)),
}


def class_names(name: str, num_classes: int = 0) -> list:
    """Human-readable class vocabulary for ``samples_fid`` exports.

    The reference hardcodes the Inria city vocabulary for every dataset
    (inference.py:110-111, data_load.py:246-252), mislabeling
    EuroSAT/CIFAR class exports; here each dataset gets its own names with a
    generic ``class{i}`` fallback."""
    names = list(_CLASS_NAMES.get(name, ()))
    n = num_classes or len(names)
    if len(names) < n:
        names += [f"class{i}" for i in range(len(names), n)]
    return names[:n] if n else names
