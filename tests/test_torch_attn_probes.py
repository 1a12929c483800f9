"""The port's plain attention-probe functions (eo_diffusion_torch.ops.attn_probes)
against the JAX package's probes on the CPU in f32:

* the transposed-output attention against ``kern_transposed`` through
  ``transposed_attn`` (``tools/probe_packed_pv.py``) in interpret mode and
  against ``_qkv5_ref_attention`` (XLA), plus a ragged T against the latter;
* the batched matmul probe against ``jax.lax.dot_general`` in the seven
  contraction forms of ``tools/probe_attn_matmuls.py``'s ``main()``, at
  reduced sizes, NK products summed as its ``_bench`` body sums them.

The probe file is loaded as it stands; only the loaded module's ``pl`` is
replaced by a namespace whose ``pallas_call`` runs in interpret mode, and the
two JAX cache settings its import changes are put back. Every JAX result
comes from one jitted function."""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from eo_diffusion_torch.ops import attn_probes as AP
from eo_diffusion_torch.tools import probe_attn_matmuls, probe_packed_pv
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
# relative to max|reference|: f32 sums in another order
REL = 1e-5
B, H, T, D, BLOCK = 1, 2, 64, 48, 32  # the Pallas kernel at blocks of 32
T_RAGGED = 37
NK = 2
BQ, BK = 16, 32  # the probe's 512 and 2048, cut down
# the probe's seven forms: (contraction of dot_general, a's cell, b's cell, layout)
FORMS = [(((1,), (1,)), (BQ, D), (BK, D), "nt"),
         (((1,), (1,)), (BQ, 128), (BK, 128), "nt"),
         (((1,), (1,)), (BK, D), (BQ, D), "nt"),
         (((1,), (0,)), (BQ, BK), (BK, D), "nn"),
         (((1,), (0,)), (BQ, BK), (BK, 128), "nn"),
         (((0,), (0,)), (BK, D), (BK, BQ), "tn"),
         (((1,), (0,)), (BQ, BK), (BK, 96), "nn")]


@pytest.fixture(scope="module")
def probe():
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_probe_packed_pv", ROOT / "tools" / "probe_packed_pv.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)
    return mod


@pytest.fixture(scope="module")
def results(probe):
    """Inputs and every JAX result (one jitted function)."""
    rng = np.random.default_rng(0)
    qkv5 = rng.normal(size=(B, 3, H, T, D)).astype(np.float32)
    qkv5[:, :2] *= 2.0  # a sharper softmax than unit inputs
    ragged = rng.normal(size=(2, 3, 3, T_RAGGED, 40)).astype(np.float32)
    mats = [(rng.normal(size=(3,) + a).astype(np.float32),
             rng.normal(size=(3,) + b).astype(np.float32)) for _, a, b, _ in FORMS]

    def everything(qkv5, ragged, mats):
        prods = []
        for (contract, _, _, _), (a, b) in zip(FORMS, mats):
            dims = ((tuple(c + 1 for c in contract[0]), tuple(c + 1 for c in contract[1])),
                    ((0,), (0,)))
            acc = None
            for _ in range(NK):  # the probe body's NK products, summed
                r = jax.lax.dot_general(a, b, dims, preferred_element_type=jnp.float32)
                acc = r if acc is None else acc + r
            prods.append(acc)
        return (probe.transposed_attn(qkv5, block_q=BLOCK, block_k=BLOCK),
                probe._qkv5_ref_attention(qkv5), probe._qkv5_ref_attention(ragged), prods)

    out = jax.jit(everything)(jnp.asarray(qkv5), jnp.asarray(ragged),
                              [(jnp.asarray(a), jnp.asarray(b)) for a, b in mats])
    pallas, ref, ref_ragged, prods = jax.tree_util.tree_map(np.asarray, out)
    return {"qkv5": qkv5, "ragged": ragged, "mats": mats, "pallas": pallas, "ref": ref,
            "ref_ragged": ref_ragged, "prods": prods}


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return (got - torch.tensor(want)).abs().max().item() / np.abs(want).max()


def test_transposed_attention_matches_pallas_and_xla(results):
    got = AP.transposed_attention_reference(torch.tensor(results["qkv5"]))
    assert got.shape == (B, H, D, T) and got.dtype == torch.float32
    assert _rel(got, results["pallas"]) <= REL
    assert _rel(got, results["ref"].transpose(0, 1, 3, 2)) <= REL  # [B,H,T,D] -> [B,H,D,T]


def test_transposed_attention_ragged_t(results):
    got = AP.transposed_attention_reference(torch.tensor(results["ragged"]))
    assert got.shape == (2, 3, 40, T_RAGGED)
    assert _rel(got, results["ref_ragged"].transpose(0, 1, 3, 2)) <= REL


@pytest.mark.parametrize("i", range(len(FORMS)), ids=[
    "qk", "qk-pad128", "qk-transposed-out", "pv", "pv-pad128", "pv-transposed", "pv-pack96"])
def test_matmul_probe_matches_dot_general(results, i):
    a, b = (torch.tensor(m) for m in results["mats"][i])
    layout = FORMS[i][3]
    got = AP.matmul_probe_reference(a, b, layout)
    want = results["prods"][i]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= REL
    assert torch.equal(AP.matmul_probe(a, b, layout), got)  # CPU: the plain version


def test_the_tools_forms_are_the_probes():
    """The port's tool runs the same seven layouts and output shapes, at the
    probe's full sizes."""
    full = {"nt": (512, 2048), "nn": (512, 48), "tn": (48, 512)}
    layouts = [v[0] for v in probe_attn_matmuls.VARIANTS.values()]
    assert layouts == [f[3] for f in FORMS]
    first = next(iter(probe_attn_matmuls.VARIANTS.values()))
    assert probe_attn_matmuls.out_cell(*first[:3]) == full["nt"]
    ms, by = probe_attn_matmuls.launch_bound(*first)
    assert by == "bytes" and abs(ms - 64 * (2 * (512 + 2048) * 48 + 4 * 512 * 2048)
                                 / 3.35e12 * 1e3) < 1e-9
    ms, by = probe_packed_pv.attention_bound_ms(8, 4096, 8, 48)
    assert by == "operations" and abs(ms - 0.2085) < 1e-4


def test_entries_and_refusals():
    rng = np.random.default_rng(3)
    qkv5 = torch.tensor(rng.normal(size=(1, 3, 2, 10, 16)).astype(np.float32))
    before = (AP.transposed_attention_cuda.launches, AP.matmul_probe_cuda.launches)
    assert torch.equal(AP.transposed_attention(qkv5), AP.transposed_attention_reference(qkv5))
    a, b = torch.ones(2, 8, 16), torch.ones(2, 24, 16)
    assert torch.equal(AP.matmul_probe(a, b, "nt"), torch.full((2, 8, 24), 32.0))
    assert (AP.transposed_attention_cuda.launches, AP.matmul_probe_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        AP.transposed_attention_cuda(qkv5)
    with pytest.raises(ValueError, match="CUDA"):
        AP.matmul_probe_cuda(a.bfloat16(), b.bfloat16(), "nt")
    with pytest.raises(ValueError, match="contraction"):
        AP.matmul_probe(a, b, "nn")
    with pytest.raises(ValueError, match="layout"):
        AP.matmul_probe(a, b, "tt")
    with pytest.raises(ValueError, match="device meta"):
        AP.transposed_attention(qkv5.to("meta"))
    with pytest.raises(ValueError, match="device meta"):
        AP.matmul_probe(a.to("meta"), b.to("meta"), "nt")
    for tool in (probe_attn_matmuls, probe_packed_pv):
        if not torch.cuda.is_available():
            with pytest.raises(SystemExit, match="CUDA"):
                tool.run()
