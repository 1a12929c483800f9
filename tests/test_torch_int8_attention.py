"""The port's plain W8A8 attention core (eo_diffusion_torch.ops.int8_attention)
against the JAX package's Pallas kernel ``_int8_kernel`` through
``core_int8_pallas`` in interpret mode, on the CPU at the probe's own cell
shape (T 256, D 64, its module globals) with B*H 3.

Importing the probe module sets JAX's compilation cache directory and its
threshold; the fixture puts both back, so later JAX tests in this process
keep their own cache."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.ops import int8_attention as I8
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def probe():
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_probe_int8_attn", ROOT / "tools" / "probe_int8_attn.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def cells(probe):
    """bf16 and f32 inputs [3, T, D], and the Pallas kernel's outputs for both
    (one jitted function, interpret mode read at call time)."""
    rng = np.random.default_rng(0)
    x = [(rng.normal(size=(3, probe.T, probe.D)) * s).astype(np.float32)
         for s in (2.0, 2.0, 1.0)]
    x[0][1] *= 4.0  # one cell with a sharp softmax (l near 1)
    run = jax.jit(probe.core_int8_pallas)
    mp = pytest.MonkeyPatch()
    mp.setenv("EO_PALLAS_INTERPRET", "1")
    try:
        out = {dt: np.asarray(run(*(jnp.asarray(a, dt) for a in x))).astype(np.float32)
               for dt in (jnp.float32, jnp.bfloat16)}
    finally:
        mp.undo()
    return x, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_pallas_kernel(cells, dtype):
    x, out = cells
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in x)
    plain, l, s_v = I8.int8_attention_reference(q, k, v, return_stats=True)
    assert plain.dtype == tdt and plain.shape == q.shape
    ref = out[getattr(jnp, dtype)]
    diff = (plain.float() - torch.from_numpy(ref)).abs()
    assert bool((diff <= I8.tolerance(plain, l, s_v)).all()), diff.max().item()
    # where exp agrees to the last bit the two are the same function: the
    # bound is for rare rounding steps, not for the bulk
    assert (diff > 1e-6 * plain.float().abs().max()).float().mean().item() < 1e-2


def test_entry_and_refusals():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 64, 32)).astype(np.float32))
               for _ in range(3))
    before = I8.int8_attention_cuda.launches
    assert torch.equal(I8.int8_attention(q, k, v), I8.int8_attention_reference(q, k, v))
    assert torch.equal(I8.int8_attention(q, k, v, impl="plain"),
                       I8.int8_attention_reference(q, k, v))
    assert I8.int8_attention_cuda.launches == before  # CPU tensors take the plain version
    with pytest.raises(ValueError, match="CUDA"):
        I8.int8_attention_cuda(q, k, v)
    with pytest.raises(ValueError):
        I8.int8_attention(q, k, v, impl="pallas")
