"""Host-side numpy augmentations (NHWC, explicit RNG).

The port's copy of the JAX package's ``data/transforms.py``: the same
functions, taking the same draws from the same ``np.random.Generator``.

Re-design of the torchvision transform stacks used by the reference factories
(``data_utils/data.py:24-122``): random h/v flips, sharpness jitter,
solarize, normalize, center-crop, resize -- as pure numpy functions over
float32 HWC arrays in [0, 1], taking an explicit ``np.random.Generator`` so
the pipeline is reproducible and shardable across data-loader workers.

Joint image+mask transforms mirror the reference's channel-concat trick
(``data_load.py:295-297``): geometric ops apply to all channels, photometric
ops only to the leading image channels.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Compose",
    "RandomHorizontalFlip",
    "RandomVerticalFlip",
    "RandomSolarize",
    "RandomAdjustSharpness",
    "Normalize",
    "CenterCrop",
    "Resize",
    "random_rect_mask",
    "sr_degrade",
    "sr_cond",
]

Array = np.ndarray
Transform = Callable[[Array, np.random.Generator], Array]


class Compose:
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, x: Array, rng: np.random.Generator) -> Array:
        for t in self.transforms:
            x = t(x, rng)
        return x


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, x: Array, rng: np.random.Generator) -> Array:
        return x[:, ::-1] if rng.random() < self.p else x


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, x: Array, rng: np.random.Generator) -> Array:
        return x[::-1] if rng.random() < self.p else x


class RandomSolarize:
    """Invert pixels above threshold (cf. torchvision RandomSolarize)."""

    def __init__(self, threshold: float = 0.5, p: float = 0.1, img_channels: Optional[int] = None):
        self.threshold, self.p, self.img_channels = threshold, p, img_channels

    def __call__(self, x: Array, rng: np.random.Generator) -> Array:
        if rng.random() >= self.p:
            return x
        c = self.img_channels or x.shape[-1]
        img = x[..., :c]
        x = x.copy()
        x[..., :c] = np.where(img >= self.threshold, 1.0 - img, img)
        return x


def _smooth3x3(img: Array) -> Array:
    """PIL SMOOTH-filter blur ([[1,1,1],[1,5,1],[1,1,1]]/13), edge-replicate."""
    k = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    out = np.zeros_like(img)
    for di in range(3):
        for dj in range(3):
            out += k[di, dj] * pad[di : di + img.shape[0], dj : dj + img.shape[1]]
    return out


class RandomAdjustSharpness:
    """Blend toward/away from a 3x3 smooth blur (cf. torchvision semantics:
    factor 0 = blurred, 1 = identity, >1 = sharpened)."""

    def __init__(self, sharpness_factor: float, p: float = 0.3, img_channels: Optional[int] = None):
        self.factor, self.p, self.img_channels = sharpness_factor, p, img_channels

    def __call__(self, x: Array, rng: np.random.Generator) -> Array:
        if rng.random() >= self.p:
            return x
        c = self.img_channels or x.shape[-1]
        img = x[..., :c]
        blurred = _smooth3x3(img)
        out = np.clip(blurred + self.factor * (img - blurred), 0.0, 1.0)
        x = x.copy()
        # PIL keeps the 1px border unchanged
        x[1:-1, 1:-1, :c] = out[1:-1, 1:-1]
        return x


class Normalize:
    """(x - mean) / std per image channel ([0,1] -> [-1,1] with 0.5/0.5)."""

    def __init__(self, mean: float = 0.5, std: float = 0.5, img_channels: Optional[int] = None):
        self.mean, self.std, self.img_channels = mean, std, img_channels

    def __call__(self, x: Array, rng: np.random.Generator) -> Array:
        c = self.img_channels or x.shape[-1]
        x = x.copy()
        x[..., :c] = (x[..., :c] - self.mean) / self.std
        return x


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, x: Array, rng: np.random.Generator) -> Array:
        h, w = x.shape[:2]
        top, left = max((h - self.size) // 2, 0), max((w - self.size) // 2, 0)
        out = x[top : top + self.size, left : left + self.size]
        if out.shape[0] < self.size or out.shape[1] < self.size:
            ph, pw = self.size - out.shape[0], self.size - out.shape[1]
            out = np.pad(out, ((0, ph), (0, pw), (0, 0)))
        return out


class Resize:
    """Nearest / bilinear resize without external deps."""

    def __init__(self, size: int, method: str = "bilinear"):
        self.size, self.method = size, method

    def __call__(self, x: Array, rng: np.random.Generator) -> Array:
        h, w = x.shape[:2]
        s = self.size
        if (h, w) == (s, s):
            return x
        if self.method == "nearest":
            ri = (np.arange(s) * h / s).astype(int)
            ci = (np.arange(s) * w / s).astype(int)
            return x[ri][:, ci]
        # bilinear
        ry = np.linspace(0, h - 1, s)
        rx = np.linspace(0, w - 1, s)
        y0, x0 = np.floor(ry).astype(int), np.floor(rx).astype(int)
        y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
        wy, wx = (ry - y0)[:, None, None], (rx - x0)[None, :, None]
        a = x[y0][:, x0]
        b = x[y0][:, x1]
        c = x[y1][:, x0]
        d = x[y1][:, x1]
        return (
            a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx
        ).astype(x.dtype)


def random_rect_mask(
    shape: Tuple[int, int],
    mnw: float, mnh: float, mxw: float, mxh: float,
    rng: Optional[np.random.Generator] = None,
) -> Array:
    """Random rectangle mask for inpainting eval (reference ``make_label``,
    script_utils/utils.py:17-37): bounds are percentages of the image size.

    Returns [H, W, 1] float32 with a random ws x hs rectangle of ones.
    """
    rng = rng or np.random.default_rng()
    w, h = shape
    mnw_, mxw_ = int(w * mnw / 100), int(w * mxw / 100)
    mnh_, mxh_ = int(h * mnh / 100), int(h * mxh / 100)
    ws = int(rng.integers(mnw_, mxw_))
    hs = int(rng.integers(mnh_, mxh_))
    x = int(rng.integers(ws, w - ws))
    y = int(rng.integers(hs, h - hs))
    label = np.zeros((w, h, 1), np.float32)
    label[x : x + ws, y : y + hs] = 1.0
    return label


def sr_degrade(image: Array, factor: int) -> Array:
    """Average-pool an [N,H,W,C] (or [H,W,C]) batch by ``factor``: the
    low-res view an SR stage conditions on (beyond-reference — the
    reference's ``SuperResModel``, backbones/unet.py:828-842, takes the
    low-res pairing as given; this is the standard bicubic-free degradation
    that makes any dataset an SR dataset)."""
    squeeze = image.ndim == 3
    x = image[None] if squeeze else image
    n, h, w, c = x.shape
    assert h % factor == 0 and w % factor == 0, (h, w, factor)
    x = x.reshape(n, h // factor, factor, w // factor, factor, c)
    out = x.mean(axis=(2, 4), dtype=np.float32)
    return out[0] if squeeze else out


def sr_cond(image: Array, factor: int) -> Array:
    """The SR conditioning view: ``sr_degrade`` then nearest-upsample back
    to the target grid (reference SuperResModel upsamples its low-res input
    to the model resolution before the channel concat, unet.py:836-839).
    Shape-preserving, so the cond plumbing (concat channels, preview grids,
    first-stage encode) needs no SR-specific cases."""
    low = sr_degrade(image, factor)
    return np.repeat(np.repeat(low, factor, axis=-3), factor, axis=-2)
