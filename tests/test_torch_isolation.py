"""The port stands alone: neither eo_diffusion_torch nor chip_smoke.py imports
JAX, its libraries or the JAX package, and the package imports with JAX
made unimportable."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "eo_diffusion_tpu")


def _sources():
    return sorted((ROOT / "eo_diffusion_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
