"""ctypes bindings for the port's native C++ data library.

Two components, both under ``csrc/`` and compiled together into one shared
library:

* **patch sampler** (``csrc/patch_sampler.cc``): fuses patch-window copy,
  uint8->float32 conversion, range scaling and flip augmentation into one
  GIL-free multithreaded pass;
* **GeoTIFF reader** (``csrc/tiff_reader.cc``): dependency-free decode
  (zlib aside) of the multi-band uint16 rasters SEN12MS-CR/Inria ship as,
  which PIL cannot decode (>4 bands). Strips/tiles, chunky/planar,
  none/LZW/deflate, horizontal predictor, little/big endian.

The library is built with ``g++`` on first use into
``eo_diffusion_torch/_build/``, under a file name keyed by a hash of the two
sources, the flags and the target the compiler resolves ``-march=native``
to, so an edited source or another CPU gets its own build. A failed build
raises with the compiler's message (naming zlib when its header or library is
missing); nothing falls back to another decoder in its place.
:func:`_extract_numpy` is the plain version of :func:`extract_patches` that
the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["have_native", "extract_patches", "build_native", "library_path",
           "read_tiff", "tiff_info"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("patch_sampler.cc", "tiff_reader.cc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# the JAX package's native/Makefile flags, plus -ffp-contract=off: without it
# -march=native fuses the sampler's ``x * scale + bias`` into one FMA, whose
# single rounding differs from the plain version's two in the last bit
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-march=native",
             "-ffp-contract=off", "-shared")

_LIB = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


@functools.lru_cache(maxsize=None)
def _target() -> str:
    """The code-generation options ``-march=native`` resolves to here (the
    compiler's own command line for an empty file), so the build's key
    changes with the CPU it is built for."""
    try:
        res = subprocess.run([_cxx(), *CXX_FLAGS, "-###", "-x", "c++", "-c", os.devnull],
                             capture_output=True, text=True, timeout=60)
    except FileNotFoundError as e:
        raise RuntimeError(f"the C++ compiler {_cxx()!r} was not found; the port's "
                           "data library is built with g++") from e
    # the version and the compiler proper's options; its temporary file names vary
    return "\n".join(line.split(" -o ")[0] for line in res.stderr.splitlines()
                     if line.startswith("gcc version") or "cc1plus" in line)


def library_path() -> Path:
    """Where the library of these sources, flags and CPU target lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _target().encode())
    for name in SOURCES:
        digest.update((_CSRC / name).read_bytes())
    return BUILD_DIR / f"libeodata_{digest.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile the library into ``_build/`` unless it is there; returns its
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock_eodata", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build per checkout at a time
        if lib.exists():
            return lib
        tmp = lib.with_name(lib.name + f".tmp{os.getpid()}")
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), *(str(_CSRC / n) for n in SOURCES), "-lz"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            log = res.stdout + res.stderr
            hint = ""
            if "zlib.h" in log or "-lz" in log:
                hint = ("zlib's header or library is missing (zlib.h, libz): install "
                        "zlib's development files to build the GeoTIFF decoder; ")
            raise RuntimeError(f"building the native data library failed: {hint}"
                               f"{' '.join(cmd)} exited {res.returncode}\n{log}")
        os.replace(tmp, lib)
    return lib


def _load():
    """The library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_native()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, src_ptr in (("eo_extract_patches_u8", u8p), ("eo_extract_patches_f32", f32p)):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [
            src_ptr, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, ctypes.c_int64, f32p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ]
    lib.eo_version.restype = ctypes.c_int
    lib.eo_version.argtypes = []
    lib.eo_tiff_info.restype = ctypes.c_int
    lib.eo_tiff_info.argtypes = [ctypes.c_char_p, i64p]
    lib.eo_tiff_read.restype = ctypes.c_int
    lib.eo_tiff_read.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
    _LIB = lib
    return lib


def loaded_path() -> str:
    """The file the loaded library came from."""
    return _load()._name


def have_native() -> bool:
    """Whether the library builds (or is built) and loads."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


_TIFF_ERRORS = {
    -1: "cannot open/read file",
    -2: "not a classic TIFF",
    -3: "unsupported TIFF feature (compression/bits/planar/predictor)",
    -4: "corrupt TIFF structure",
    -5: "output buffer size mismatch",
    -6: "decompression failed",
}


def tiff_info(path: str) -> dict:
    """Parse the first IFD of a (Geo)TIFF without decoding pixel data.

    Returns ``{width, height, samples, bits, sample_format, compression,
    planar}``. Raises ``ValueError`` on unsupported/corrupt files.
    """
    lib = _load()
    info = np.zeros(8, np.int64)
    rc = lib.eo_tiff_info(os.fsencode(path),
                          info.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise ValueError(f"{path}: {_TIFF_ERRORS.get(rc, f'error {rc}')}")
    return {"width": int(info[0]), "height": int(info[1]),
            "samples": int(info[2]), "bits": int(info[3]),
            "sample_format": int(info[4]), "compression": int(info[5]),
            "planar": int(info[6])}


def read_tiff(path: str) -> np.ndarray:
    """Decode a (Geo)TIFF to ``[H, W, S]`` float32 (exact for <=24-bit
    integer samples and float32): >4-band uint16 rasters, planar layout,
    tiled organization, LZW/deflate compression, horizontal predictor."""
    meta = tiff_info(path)
    lib = _load()
    out = np.empty((meta["height"], meta["width"], meta["samples"]), np.float32)
    rc = lib.eo_tiff_read(os.fsencode(path),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
    if rc != 0:
        raise ValueError(f"{path}: {_TIFF_ERRORS.get(rc, f'error {rc}')}")
    return out


def _extract_numpy(tiles, jobs, size, scale, bias):
    n = jobs.shape[0]
    ch = tiles.shape[-1]
    out = np.empty((n, size, size, ch), np.float32)
    for p in range(n):
        ti, r, c, flip = jobs[p]
        patch = tiles[ti, r : r + size, c : c + size].astype(np.float32)
        if flip & 2:
            patch = patch[::-1]
        if flip & 1:
            patch = patch[:, ::-1]
        out[p] = patch * scale + bias
    return out


def extract_patches(
    tiles: np.ndarray,
    jobs: np.ndarray,
    size: int,
    scale: float = 1.0,
    bias: float = 0.0,
    n_threads: int = 0,
    force_numpy: bool = False,
) -> np.ndarray:
    """Extract float32 patches from a tile stack.

    :param tiles: [n_tiles, H, W, C] uint8 or float32, C-contiguous (other
                  dtypes take the plain version).
    :param jobs:  [n_patches, 4] int64 rows (tile_idx, row_off, col_off,
                  flip_bits) with flip bit0=horizontal, bit1=vertical.
    :param size:  square patch size.
    :param force_numpy: take the plain version (the tests' reference).
    :returns: [n_patches, size, size, C] float32 = src * scale + bias.
    """
    tiles = np.ascontiguousarray(tiles)
    jobs = np.ascontiguousarray(jobs, np.int64)
    if jobs.ndim != 2 or jobs.shape[1] != 4:
        raise ValueError(f"jobs must be [n, 4], got {jobs.shape}")
    n_tiles, th, tw, ch = tiles.shape
    if not ((jobs[:, 0] >= 0).all() and (jobs[:, 0] < n_tiles).all()
            and (jobs[:, 1] >= 0).all() and (jobs[:, 2] >= 0).all()
            and (jobs[:, 1] + size <= th).all() and (jobs[:, 2] + size <= tw).all()):
        raise ValueError("a patch job lies outside the tile stack")
    if force_numpy or tiles.dtype not in (np.uint8, np.float32):
        return _extract_numpy(tiles, jobs, size, scale, bias)

    lib = _load()
    out = np.empty((jobs.shape[0], size, size, ch), np.float32)
    i64p = jobs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    f32p = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if tiles.dtype == np.uint8:
        fn, src = lib.eo_extract_patches_u8, tiles.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        fn, src = lib.eo_extract_patches_f32, tiles.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    fn(src, n_tiles, th, tw, ch, i64p, jobs.shape[0], f32p, size,
       ctypes.c_float(scale), ctypes.c_float(bias), n_threads)
    return out
