"""SEN12MS-CR triplet loader (Sentinel-1 SAR / Sentinel-2 / cloudy Sentinel-2).

The port's copy of the JAX package's ``data/sen12ms_cr.py``, a re-design of
the reference's vendored TUM loader
(``data_utils/sen12ms_cr_dataLoader.py:26-233``): same band/season/sensor
enums and on-disk layout (``ROIs{id}_{season}/{sensor}_{scene}/ *_p{patch}.tif``),
numpy-native with a pluggable TIFF reader (injected in tests).

The :class:`SEN12MSCRCloudRemoval` Dataset adapter emits the cloud-removal
training dict: clear S2 RGB as "image", cloudy S2 RGB as "cond_image",
matching the thesis use-case (README.md:13-20).
"""

from __future__ import annotations

import glob
import os
from enum import Enum
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from eo_diffusion_torch.data.datasets import Dataset

__all__ = ["S1Bands", "S2Bands", "Seasons", "Sensor", "SEN12MSCR", "SEN12MSCRCloudRemoval"]


class S1Bands(Enum):
    VV = 1
    VH = 2
    ALL = (1, 2)


class S2Bands(Enum):
    B01 = 1; B02 = 2; B03 = 3; B04 = 4; B05 = 5; B06 = 6; B07 = 7
    B08 = 8; B08A = 9; B09 = 10; B10 = 11; B11 = 12; B12 = 13
    ALL = tuple(range(1, 14))
    RGB = (4, 3, 2)


class Seasons(Enum):
    SPRING = "ROIs1158_spring"
    SUMMER = "ROIs1868_summer"
    FALL = "ROIs1970_fall"
    WINTER = "ROIs2017_winter"


class Sensor(Enum):
    s1 = "s1"
    s2 = "s2"
    s2cloudy = "s2_cloudy"


def _default_reader(path: str, bands: Sequence[int]) -> np.ndarray:
    """Read selected 1-indexed bands of a GeoTIFF -> [H, W, len(bands)].

    Preference order: rasterio (full GeoTIFF semantics) > the port's native
    C++ decoder (``csrc/tiff_reader.cc`` via data/native.py, which decodes
    the 13-band uint16 S2 rasters PIL cannot) > tifffile > PIL. The native
    library is built on first use; a failed build raises rather than
    handing the file to the readers after it. Only a layout the decoder
    does not support (``ValueError``) goes on to tifffile and PIL.
    """
    try:
        import rasterio

        with rasterio.open(path) as f:
            data = f.read(list(bands))  # [B, H, W]
        return np.moveaxis(data, 0, -1)
    except ImportError:
        pass
    from eo_diffusion_torch.data.native import read_tiff

    try:
        data = read_tiff(path)  # [H, W, S] float32
        return data[:, :, [b - 1 for b in bands]]
    except ValueError:
        pass  # exotic layout -> try the python readers below
    try:
        import tifffile

        data = tifffile.imread(path)
    except ImportError:
        from PIL import Image

        data = np.asarray(Image.open(path))
    if data.ndim == 2:
        data = data[:, :, None]
    if data.shape[0] < data.shape[-1]:  # band-major layout
        data = np.moveaxis(data, 0, -1)
    return data[:, :, [b - 1 for b in bands]]


def _band_list(bands) -> List[int]:
    if isinstance(bands, (list, tuple)):
        out = []
        for b in bands:
            out.extend(_band_list(b))
        return out
    if isinstance(bands, Enum):
        v = bands.value
        return list(v) if isinstance(v, (list, tuple)) else [v]
    return [int(bands)]


class SEN12MSCR:
    """Scene/patch indexing + triplet reading over the SEN12MS-CR layout."""

    def __init__(self, base_dir: str, reader: Optional[Callable] = None):
        if not os.path.exists(base_dir):
            raise FileNotFoundError(f"SEN12MS-CR base_dir does not exist: {base_dir}")
        self.base_dir = base_dir
        self.reader = reader or _default_reader

    def get_scene_ids(self, season: Union[str, Seasons]) -> set:
        season = Seasons(season).value
        path = os.path.join(self.base_dir, season)
        if not os.path.exists(path):
            raise NameError(f"Could not find season {season} in {self.base_dir}")
        # exclude s2_cloudy dirs, which would break the id split (same guard
        # as the reference, sen12ms_cr_dataLoader.py:96-99)
        return {
            int(os.path.basename(s).split("_")[1])
            for s in glob.glob(os.path.join(path, "s2_*"))
            if os.path.isdir(s) and "cloudy" not in os.path.basename(s)
        }

    def get_patch_ids(self, season: Union[str, Seasons], scene_id: int) -> List[int]:
        season = Seasons(season).value
        path = os.path.join(self.base_dir, season, f"s2_{scene_id}")
        if not os.path.exists(path):
            raise NameError(f"Could not find scene {scene_id} in {season}")
        ids = []
        for p in glob.glob(os.path.join(path, "*")):
            stem = os.path.splitext(os.path.basename(p))[0]
            ids.append(int(stem.rsplit("_", 1)[1][1:]))  # ..._p<ID>
        return sorted(ids)

    def _patch_path(self, season: str, sensor: Sensor, scene_id: int, patch_id: int) -> str:
        scene = f"{sensor.value}_{scene_id}"
        fname = f"{season}_{scene}_p{patch_id}.tif"
        return os.path.join(self.base_dir, season, scene, fname)

    def get_patch(self, season, sensor: Sensor, scene_id: int, patch_id: int,
                  bands) -> np.ndarray:
        season = Seasons(season).value
        path = self._patch_path(season, sensor, scene_id, patch_id)
        return self.reader(path, _band_list(bands))

    def get_s1_s2_s2cloudy_triplet(
        self, season, scene_id: int, patch_id: int,
        s1_bands=S1Bands.ALL, s2_bands=S2Bands.ALL, s2cloudy_bands=S2Bands.ALL,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One (S1, S2, cloudy-S2) patch triplet (reference
        sen12ms_cr_dataLoader.py:150-233)."""
        s1 = self.get_patch(season, Sensor.s1, scene_id, patch_id, s1_bands)
        s2 = self.get_patch(season, Sensor.s2, scene_id, patch_id, s2_bands)
        s2c = self.get_patch(season, Sensor.s2cloudy, scene_id, patch_id, s2cloudy_bands)
        return s1, s2, s2c


class SEN12MSCRCloudRemoval(Dataset):
    """Cloud-removal Dataset: {"image": clear S2 RGB, "cond_image": cloudy S2
    RGB, "sar": S1} with reflectance scaling to [0, 1] (S2 DN / 10000)."""

    data_range = (0.0, 1.0)

    def __init__(self, base_dir: str, season=Seasons.SUMMER,
                 reader: Optional[Callable] = None, scale: float = 1.0 / 10000.0):
        self.api = SEN12MSCR(base_dir, reader=reader)
        self.season = Seasons(season)
        self.scale = scale
        self.index: List[Tuple[int, int]] = []
        for sid in sorted(self.api.get_scene_ids(self.season)):
            for pid in self.api.get_patch_ids(self.season, sid):
                self.index.append((sid, pid))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i):
        sid, pid = self.index[i]
        s1, s2, s2c = self.api.get_s1_s2_s2cloudy_triplet(
            self.season, sid, pid,
            s1_bands=S1Bands.ALL, s2_bands=S2Bands.RGB, s2cloudy_bands=S2Bands.RGB,
        )
        to01 = lambda x: np.clip(x.astype(np.float32) * self.scale, 0.0, 1.0)
        return {
            "image": to01(s2),
            "cond_image": to01(s2c),
            "sar": s1.astype(np.float32),
        }
