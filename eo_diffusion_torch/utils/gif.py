"""PNG-sequence -> GIF assembly (the port's own copy of
``eo_diffusion_tpu/utils/gif.py``; replaces reference ``assets/make_gif.py``).
PIL is imported when a GIF is made."""

from __future__ import annotations

import glob
import os
from typing import Sequence, Union

import numpy as np

__all__ = ["make_gif"]


def make_gif(
    frames: Union[str, Sequence],
    out_path: str,
    pattern: str = "*.png",
    duration_ms: int = 100,
    loop: int = 0,
) -> str:
    """Assemble a GIF from a directory of PNGs or a list of arrays/paths.

    ``frames`` may be a directory (globbed+sorted with ``pattern``), a list of
    file paths, or a list of [H,W,C] float [0,1] / uint8 arrays.
    """
    from PIL import Image

    if isinstance(frames, str):
        paths = sorted(glob.glob(os.path.join(frames, pattern)))
        imgs = [Image.open(p).convert("RGB") for p in paths]
    else:
        imgs = []
        for f in frames:
            if isinstance(f, str):
                imgs.append(Image.open(f).convert("RGB"))
            else:
                arr = np.asarray(f)
                if arr.dtype != np.uint8:
                    arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
                if arr.ndim == 3 and arr.shape[-1] == 1:
                    arr = arr[:, :, 0]
                imgs.append(Image.fromarray(arr).convert("RGB"))
    if not imgs:
        raise ValueError("no frames to assemble")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                 duration=duration_ms, loop=loop)
    return out_path
