"""The port's kernel build (eo_diffusion_torch.ops._build) without a GPU: a
stand-in ``nvcc`` shows the build, cache and failure paths."""

import os
import re
import stat
from pathlib import Path

import pytest

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops import attn_probes as AP
from eo_diffusion_torch.ops import attn_variants as AV
from eo_diffusion_torch.ops import softmax_probes as SP

FAKE_NVCC = """#!/bin/sh
# stand-in compiler: write the -o target, or fail when the source says so
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift ;; *.cu) src="$1" ;; esac
  shift
done
if grep -q FAIL "$src"; then echo "error: bad source" ; exit 2; fi
echo "ptxas info    : Used 32 registers"
echo built > "$out"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel v1\n")
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "KERNELS", {"k": "k.cu"})
    monkeypatch.setattr(_build, "_loaded", {})
    return csrc / "k.cu"


def test_build_caches_by_source_hash(fake_toolchain):
    first = _build.build_all()["k"]
    assert first["path"].exists() and "32 registers" in first["log"]
    again = _build.build_all()["k"]  # unchanged source: reused, not rebuilt
    assert again["path"] == first["path"] and again["seconds"] == 0.0
    assert "32 registers" in again["log"]
    fake_toolchain.write_text("// kernel v2\n")  # an edited kernel gets a new library
    edited = _build.build_all()["k"]
    assert edited["path"] != first["path"] and edited["path"].exists()
    assert not [p for p in os.listdir(_build.BUILD_DIR) if ".tmp" in p]


def test_failed_build_raises_with_the_log(fake_toolchain):
    fake_toolchain.write_text("// FAIL\n")
    with pytest.raises(RuntimeError, match="bad source"):
        _build.build_all()
    assert not _build.library_path("k").exists()


def test_no_nvcc_is_a_clear_error(tmp_path, monkeypatch):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has a CUDA toolkit")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_an_edited_header_rebuilds(fake_toolchain):
    header = fake_toolchain.parent / "tile.cuh"
    header.write_text("// shared tile code v1\n")
    first = _build.build_all()["k"]["path"]
    header.write_text("// shared tile code v2\n")
    assert _build.build_all()["k"]["path"] != first


def _c_entries(source: str):
    """{name: number of parameters} of the ``extern "C"`` functions of a source."""
    text = (Path(_build.__file__).parent / "csrc" / source).read_text()
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)}


def test_every_kernel_has_its_source():
    csrc = Path(_build.__file__).parent / "csrc"
    assert all((csrc / src).is_file() for src in _build.KERNELS.values())
    assert {"softmax_probes", "attn_variants"} <= set(_build.KERNELS)


@pytest.mark.parametrize("kernel,entry,argtypes", [
    ("softmax_probes", "eo_softmax_stats", SP._ARGTYPES["eo_softmax_stats"]),
    ("softmax_probes", "eo_transpose_accumulate", SP._ARGTYPES["eo_transpose_accumulate"]),
    ("attn_variants", "eo_attention_variant", AV._ARGTYPES),
    ("attn_probes", "eo_attention_hybrid", AP._ARGTYPES["eo_attention_hybrid"]),
], ids=lambda x: x if isinstance(x, str) else "")
def test_the_probe_wrappers_declare_their_c_entries(kernel, entry, argtypes):
    """The ctypes declarations of the probe kernels' wrappers match the C
    entries in number (a missing argument would shift every one after it)."""
    entries = _c_entries(_build.KERNELS[kernel])
    assert entries[entry] == len(argtypes)
