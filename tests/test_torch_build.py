"""The port's kernel build (eo_diffusion_torch.ops._build) without a GPU: a
stand-in ``nvcc`` shows the build, cache and failure paths."""

import os
import re
import stat
from pathlib import Path

import pytest

import shutil

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.ops import attn_probes as AP
from eo_diffusion_torch.ops import attn_variants as AV
from eo_diffusion_torch.ops import conv_wgrad as CW
from eo_diffusion_torch.ops import group_norm as GN
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
    ("attention_fwd_sm90", "eo_qkv_attention_fwd", A._ARGTYPES["eo_qkv_attention_fwd"]),
    ("attention_fwd_sm90", "eo_attention_fwd", A._ARGTYPES["eo_attention_fwd"]),
    ("attention_fwd", "eo_qkv_attention_fwd_mma", A._ARGTYPES["eo_qkv_attention_fwd_mma"]),
    ("attention_fwd", "eo_attention_fwd_mma", A._ARGTYPES["eo_attention_fwd_mma"]),
    ("attention_bwd_sm90", "eo_qkv_attention_bwd", A._ARGTYPES["eo_qkv_attention_bwd"]),
    ("attention_bwd_sm90", "eo_attention_bwd", A._ARGTYPES["eo_attention_bwd"]),
    ("attention_bwd", "eo_qkv_attention_bwd_mma", A._ARGTYPES["eo_qkv_attention_bwd_mma"]),
    ("attention_bwd", "eo_attention_bwd_mma", A._ARGTYPES["eo_attention_bwd_mma"]),
    ("group_norm_sm90", "eo_gn_sm90_fwd", GN._ARGTYPES["eo_gn_sm90_fwd"]),
    ("group_norm_sm90", "eo_gn_sm90_bwd", GN._ARGTYPES["eo_gn_sm90_bwd"]),
    ("group_norm_sm90", "eo_gn_sm90_blocks_per_sm", GN._ARGTYPES["eo_gn_sm90_blocks_per_sm"]),
    ("group_norm", "eo_group_norm_fwd", GN._ARGTYPES["eo_group_norm_fwd"]),
    ("group_norm", "eo_group_norm_bwd", GN._ARGTYPES["eo_group_norm_bwd"]),
    ("conv_wgrad", "eo_conv_wgrad", CW._ARGTYPES),
    ("conv_wgrad_sm90", "eo_conv_wgrad_sm90", CW._ARGTYPES_SM90),
], ids=lambda x: x if isinstance(x, str) else "")
def test_the_probe_wrappers_declare_their_c_entries(kernel, entry, argtypes):
    """The ctypes declarations of the probe kernels' wrappers match the C
    entries in number (a missing argument would shift every one after it)."""
    entries = _c_entries(_build.KERNELS[kernel])
    assert entries[entry] == len(argtypes)


def test_the_wgmma_forward_is_listed_and_its_header_hashed(tmp_path, monkeypatch):
    """The wgmma/TMA forward is a kernel of its own (built by build_all, so by
    chip_smoke.py), and an edit of its warpgroup header rebuilds it."""
    csrc = Path(_build.__file__).parent / "csrc"
    assert _build.KERNELS["attention_fwd_sm90"] == "attention_fwd_sm90.cu"
    assert A._KERNEL_SM90 == "attention_fwd_sm90"
    assert '#include "wgmma_tile.cuh"' in (csrc / "attention_fwd_sm90.cu").read_text()
    copy = tmp_path / "csrc"
    shutil.copytree(csrc, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    first = _build.library_path("attention_fwd_sm90")
    header = copy / "wgmma_tile.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert _build.library_path("attention_fwd_sm90") != first


def test_the_wgmma_backward_is_listed_and_its_header_hashed(tmp_path, monkeypatch):
    """The wgmma/TMA backward is a kernel of its own beside the mma.sync body
    (built by build_all, so by chip_smoke.py), on the forward's warpgroup
    header: an edit of the header rebuilds both bodies, not the old one."""
    csrc = Path(_build.__file__).parent / "csrc"
    assert _build.KERNELS["attention_bwd_sm90"] == "attention_bwd_sm90.cu"
    assert A._KERNEL_BWD_SM90 == "attention_bwd_sm90"
    assert '#include "wgmma_tile.cuh"' in (csrc / "attention_bwd_sm90.cu").read_text()
    assert "wgmma_tile.cuh" not in (csrc / "attention_bwd.cu").read_text()
    copy = tmp_path / "csrc"
    shutil.copytree(csrc, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    names = ("attention_bwd_sm90", "attention_fwd_sm90")
    first = {n: _build.library_path(n) for n in names}
    header = copy / "wgmma_tile.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert all(_build.library_path(n) != first[n] for n in names)


def test_the_one_launch_group_norm_is_listed_and_its_header_hashed(tmp_path, monkeypatch):
    """The one-launch GroupNorm body is a kernel of its own beside the old
    body (built by build_all, so by chip_smoke.py), on the warpgroup header's
    mbarrier and bulk-copy helpers: an edit of the header rebuilds it."""
    csrc = Path(_build.__file__).parent / "csrc"
    assert _build.KERNELS["group_norm_sm90"] == "group_norm_sm90.cu"
    assert _build.KERNELS["group_norm"] == "group_norm.cu"
    assert GN._KERNEL_SM90 == "group_norm_sm90" and GN._KERNEL == "group_norm"
    src = (csrc / "group_norm_sm90.cu").read_text()
    assert '#include "wgmma_tile.cuh"' in src and "cudaLaunchCooperativeKernel" in src
    assert "wgmma_tile.cuh" not in (csrc / "group_norm.cu").read_text()
    copy = tmp_path / "csrc"
    shutil.copytree(csrc, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    first = _build.library_path("group_norm_sm90")
    header = copy / "wgmma_tile.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert _build.library_path("group_norm_sm90") != first


def test_the_planner_and_the_kernel_share_their_limits():
    """The planner's constants are the CUDA source's: the shared memory a
    block, the pieces, the teams' counters and the blocks a combine takes."""
    src = (Path(_build.__file__).parent / "csrc" / "group_norm_sm90.cu").read_text()
    consts = {m.group(1): int(m.group(2))
              for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kMaxSmem"] == GN.SMEM_PER_BLOCK
    assert consts["kMaxPieces"] == GN.MAX_PIECES
    assert consts["kMaxTeams"] == GN.MAX_TEAMS
    assert consts["kMaxThreads"] == GN.MAX_THREADS
    assert consts["kMaxThreadsFwd"] == GN.WIDE_THREADS
    assert 32 * consts["kMaxPerLane"] == GN.MAX_BLOCKS
    assert "1024 / C" in src and GN.stage_slots(128) == 8 and GN.stage_slots(4096) == 1


@pytest.mark.parametrize("source", ["conv_wgrad.cu", "conv_wgrad_sm90.cu"])
def test_the_wgrad_bodies_share_the_wrappers_tiles(source):
    """Both weight-gradient bodies tile dy as the wrappers' split planners
    assume (kTH x kTW pixels, kCT channels), and the wgmma body is a kernel
    of its own on the warpgroup header."""
    src = (Path(_build.__file__).parent / "csrc" / source).read_text()
    consts = {name: int(value) for decl in re.findall(r"constexpr int ([^;]+);", src)
              for name, value in re.findall(r"(k\w+) = (\d+)\b(?![^,]*[*/+(])", decl)}
    assert (consts["kTH"], consts["kTW"], consts["kCT"]) == (CW.TILE_H, CW.TILE_W, CW.TILE_C)
    assert _build.KERNELS[CW._KERNEL_SM90] == "conv_wgrad_sm90.cu"
    assert ('#include "wgmma_tile.cuh"' in src) == (source == "conv_wgrad_sm90.cu")
