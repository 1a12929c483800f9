"""The port's plain 3x3 conv weight gradient (eo_diffusion_torch.ops.conv_wgrad)
against the JAX package's prototype kernel ``_wgrad_kernel`` through
``pallas_wgrad`` in interpret mode, and against that tool's ``xla_wgrad`` (the
vjp of XLA's conv), on the CPU in f32.

The tool file is loaded as it stands; only the loaded module's ``pl`` is
replaced by a namespace whose ``pallas_call`` runs in interpret mode. Importing
it sets JAX's compilation cache directory and its threshold; the fixture puts
both back, so later JAX tests in this process keep their own cache. Every JAX
result comes from one jitted function."""

import functools
import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from eo_diffusion_torch.ops import conv_wgrad as CW
from eo_diffusion_torch.tools import prototype_wgrad_kernel as tool
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
# (B, H, W, C, Co, rows): C = Co; C != Co; Co 3 (the output conv); an H that
# is not a multiple of rows (the Pallas grid drops the rest: XLA only)
CASES = [(2, 16, 8, 8, 8, 8), (2, 16, 8, 8, 12, 8), (1, 8, 12, 16, 3, 4),
         (2, 13, 9, 6, 5, None)]
# relative to max|reference|: f32 sums of exact products in another order
REL = 1e-5


@pytest.fixture(scope="module")
def proto():
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_prototype_wgrad_kernel", ROOT / "tools" / "prototype_wgrad_kernel.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    mod.pl = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                   BlockSpec=pl.BlockSpec, program_id=pl.program_id,
                                   when=pl.when)
    return mod


@pytest.fixture(scope="module")
def results(proto):
    """Inputs and the JAX results of every case (one jitted function)."""
    rng = np.random.default_rng(0)
    inputs = [(rng.normal(size=(b, h, w, c)).astype(np.float32),
               rng.normal(size=(b, h, w, co)).astype(np.float32))
              for b, h, w, c, co, _ in CASES]

    def all_cases(arrays):
        out = []
        for (x, dy), case in zip(arrays, CASES):
            rows = case[-1]
            out.append((None if rows is None else proto.pallas_wgrad(x, dy, rows=rows),
                        proto.xla_wgrad(x, dy)))
        return out

    jax_out = jax.jit(all_cases)([(jnp.asarray(x), jnp.asarray(dy)) for x, dy in inputs])
    return inputs, [tuple(None if r is None else np.asarray(r) for r in pair)
                    for pair in jax_out]


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return (got - torch.tensor(want)).abs().max().item() / np.abs(want).max()


@pytest.mark.parametrize("i", range(len(CASES)), ids=[
    "c8-co8", "c8-co12", "c16-co3", "h13-not-a-multiple-of-rows"])
def test_plain_matches_pallas_and_xla(results, i):
    inputs, jax_out = results
    x, dy = (torch.from_numpy(a) for a in inputs[i])
    got = CW.conv_wgrad_reference(x, dy)
    b, h, w, c, co, _ = CASES[i]
    assert got.shape == (3, 3, c, co) and got.dtype == torch.float32
    pallas, xla = jax_out[i]
    assert _rel(got, xla) <= REL
    if pallas is not None:
        assert _rel(got, pallas) <= REL


def test_oihw_is_the_conv_weights_gradient():
    """hwio_to_oihw of the plain result is what autograd gives a torch conv's
    weight (cross-correlation with padding 1)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 6, 7, 4)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(2, 6, 7, 5)).astype(np.float32))
    w = torch.zeros(5, 4, 3, 3, requires_grad=True)
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    (want,) = torch.autograd.grad(y, w, dy.permute(0, 3, 1, 2))
    got = CW.hwio_to_oihw(CW.conv_wgrad_reference(x, dy))
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= REL * want.abs().max().item()


def test_entry_and_refusals():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(1, 5, 6, 3)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(1, 5, 6, 2)).astype(np.float32))
    before = CW.conv_wgrad_cuda.launches
    ref = CW.conv_wgrad_reference(x, dy)
    assert torch.equal(CW.conv_wgrad(x, dy), ref)
    assert CW.conv_wgrad_cuda.launches == before  # CPU tensors take the plain version
    with pytest.raises(ValueError, match="CUDA"):
        CW.conv_wgrad_cuda(x, dy)
    with pytest.raises(ValueError, match="device meta"):
        CW.conv_wgrad(x.to("meta"), dy.to("meta"))
    with pytest.raises(ValueError):
        CW.conv_wgrad_reference(x, dy[:, :4])


def test_bound_and_splits_at_the_tools_shape():
    ms, by = tool.wgrad_bound_ms(8, 256, 256, 128, 128, torch.bfloat16)
    assert by == "operations" and abs(ms - 154.6e9 / 989e12 * 1e3) < 1e-3
    assert CW.splits(8, 256, 256, 128, 128, 132) == 33  # 4 tile pairs, one wave
    assert CW.splits(8, 32, 32, 1024, 512, 132) == 1  # 128 tile pairs already
    assert CW.splits(1, 8, 16, 8, 8, 132) == 1  # one dy tile


def test_tool_runs_the_plain_version_on_the_cpu(capsys):
    res = tool.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and res["device"] == "cpu"
    assert res["max_abs_err_vs_autograd"] <= REL * res["max_abs"]
