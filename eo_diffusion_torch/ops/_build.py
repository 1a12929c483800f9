"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface (no PyTorch
headers, so ``nvcc`` takes seconds). It is compiled for ``sm_90a`` on first
use into ``eo_diffusion_torch/_build/`` (listed in ``.gitignore``), under a
file name keyed by a hash of its source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited kernel is rebuilt and an unchanged one is
reused. :func:`build_all` starts one ``nvcc`` per source at once. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["KERNELS", "nvcc_path", "library_path", "build_all", "load"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"

#: kernel name -> its CUDA source under csrc/
KERNELS = {"attention_fwd": "attention_fwd.cu", "attention_fwd_sm90": "attention_fwd_sm90.cu",
           "attention_bwd": "attention_bwd.cu", "attention_bwd_sm90": "attention_bwd_sm90.cu",
           "attention_wide": "attention_wide.cu",
           "group_norm": "group_norm.cu", "group_norm_sm90": "group_norm_sm90.cu",
           "int8_attention": "int8_attention.cu",
           "conv_wgrad": "conv_wgrad.cu", "conv_wgrad_sm90": "conv_wgrad_sm90.cu",
           "attn_probes": "attn_probes.cu",
           "softmax_probes": "softmax_probes.cu", "attn_variants": "attn_variants.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or ``nvcc`` on ``PATH``; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the GPU")
    return found


def library_path(name: str) -> Path:
    src = _CSRC / KERNELS[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(_CSRC.glob("*.cuh")):  # shared headers a source may include
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build every kernel not built yet, one ``nvcc`` per source, all started
    together. Returns ``{name: {"path", "seconds", "log"}}``; ``log`` holds
    ptxas's register/shared-memory report. Raises if a build fails."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build per checkout at a time
        procs, out = {}, {}
        t0 = time.perf_counter()
        for name in names:
            lib = library_path(name)
            if lib.exists():
                log = lib.with_suffix(".log")
                out[name] = {"path": lib, "seconds": 0.0,
                             "log": log.read_text() if log.exists() else ""}
                continue
            tmp = lib.with_name(lib.name + f".tmp{os.getpid()}")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / KERNELS[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                continue
            os.replace(tmp, lib)
            lib.with_suffix(".log").write_text(log)
            out[name] = {"path": lib, "seconds": time.perf_counter() - t0, "log": log}
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    if name not in _loaded:
        path = build_all([name])[name]["path"]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
