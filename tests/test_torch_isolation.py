"""The port stands alone: neither eo_diffusion_torch nor chip_smoke.py, the
root wrappers train_torch.py and inference_torch.py or the demos of
examples/torch/ import JAX, its libraries or the JAX package, no source of
it (C++ and CUDA included) names a path under the JAX package or native/ for
its code to open, and the package imports with JAX made unimportable. The
one stated exception is tools/jax_ckpt_to_torch.py, which bridges the two
packages' checkpoints and which no module of the port imports."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "eo_diffusion_tpu")


# the converter of JAX checkpoints: it imports both packages by design
BRIDGE = ROOT / "tools" / "jax_ckpt_to_torch.py"


def _sources():
    return (sorted((ROOT / "eo_diffusion_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + [ROOT / "train_torch.py", ROOT / "inference_torch.py"]
            + sorted((ROOT / "examples" / "torch").glob("*.py")))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_probe_modules_are_checked():
    """The probe kernels' modules and tools are among the sources checked."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for mod in ("ops/softmax_probes.py", "ops/attn_variants.py", "ops/attn_probes.py",
                "tools/probe_softmax_orient.py", "tools/profile_attn_variants.py",
                "tools/profile_attn_variants2.py", "tools/profile_attn_fusedlayout.py"):
        assert f"eo_diffusion_torch/{mod}" in names, mod


def test_the_guidance_modules_are_checked():
    """The samplers, the guidance wrappers and the post-hoc EMA are among the
    sources checked (and imported without JAX by
    test_package_imports_without_jax)."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for mod in ("diffusion/dpm_solver.py", "diffusion/unipc.py", "diffusion/deepcache.py",
                "diffusion/pag.py", "diffusion/autoguide.py", "diffusion/edit.py",
                "train/posthoc_ema.py", "diffusion/edm.py", "diffusion/bridge.py"):
        assert f"eo_diffusion_torch/{mod}" in names, mod


def test_the_restoration_modules_are_checked():
    """The classifier, classifier guidance, DDNM, their CLIs and the frame
    helpers are among the sources checked (and imported without JAX by
    test_package_imports_without_jax)."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for mod in ("models/encoder_unet.py", "diffusion/classifier_guidance.py",
                "diffusion/inverse.py", "cli/train_classifier.py", "cli/restore.py",
                "utils/viz.py", "utils/gif.py"):
        assert f"eo_diffusion_torch/{mod}" in names, mod


def test_the_entry_points_and_demos_are_checked():
    """The root wrappers and the four demos are among the sources checked;
    the JAX-checkpoint converter is the one file that imports both packages,
    outside both, and nothing of the port imports it."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for f in ("train_torch.py", "inference_torch.py", *(
            f"examples/torch/{d}_demo.py"
            for d in ("cloud_removal", "change_pair", "inpainting", "modern_stack"))):
        assert f in names, f
    assert BRIDGE.relative_to(ROOT).as_posix() not in names
    roots = set(_imported_roots(BRIDGE))
    assert {"jax", "eo_diffusion_tpu"} <= roots and "eo_diffusion_torch" in roots
    for path in _sources():
        assert not {"tools", "jax_ckpt_to_torch"} & set(_imported_roots(path)), path


# a path component naming the JAX package or its native/ library directory
_JAX_PATH = re.compile(r"(^|[/\\])(native|eo_diffusion_tpu)([/\\]|$)")
# the "file:line" of the TPU kernel a kernel replaces (a label, not a path to open)
_KERNEL_LABEL = re.compile(r"(eo_diffusion_tpu|tools)/[\w/]+\.py:\d+")


def _all_sources():
    pkg = ROOT / "eo_diffusion_torch"
    native = [p for ext in ("*.cc", "*.cu", "*.cuh", "*.h") for p in pkg.rglob(ext)]
    return _sources() + sorted(native)


def _code_strings(path: Path):
    """The string constants of a Python file that are not docstrings, or the
    text of a C++/CUDA file with its comments taken out."""
    text = path.read_text()
    if path.suffix != ".py":
        yield re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
        return
    tree = ast.parse(text, filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


@pytest.mark.parametrize("path", _all_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_into_the_jax_package_or_native(path):
    """The port keeps its own copy of what it needs: its code names no file
    under eo_diffusion_tpu/ or native/ to read, build or load at run time."""
    bad = [s for s in _code_strings(path)
           if (_JAX_PATH.search(s) if path.suffix == ".py" else
               re.search(r"native/|eo_diffusion_tpu", s))
           and not _KERNEL_LABEL.fullmatch(s)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad[:3]}"


def test_the_data_feed_sources_are_checked():
    """The data feed's modules, its C++ sources and the patch exporter are
    among the sources the path check reads."""
    names = {p.relative_to(ROOT).as_posix() for p in _all_sources()}
    for mod in ("datasets.py", "transforms.py", "patches.py", "native.py", "tile_cache.py",
                "sen12ms_cr.py", "loader.py", "device_cache.py", "factories.py",
                "csrc/tiff_reader.cc", "csrc/patch_sampler.cc"):
        assert f"eo_diffusion_torch/data/{mod}" in names, mod
    assert "eo_diffusion_torch/tools/export_patches.py" in names


def test_package_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import eo_diffusion_torch\n"
        "for m in pkgutil.walk_packages(eo_diffusion_torch.__path__, 'eo_diffusion_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")
