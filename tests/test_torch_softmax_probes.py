"""The port's softmax-orientation probes against the JAX package's probe
(``tools/probe_softmax_orient.py``) on the CPU in f32:

* the softmax statistics (``eo_diffusion_torch.ops.softmax_probes``) against
  ``bench_reduce``'s Pallas body along both axes, at the probe's cell cut
  down and at a ragged cell;
* the transpose against ``bench_transpose``'s body (bit for bit);
* the plain transposed attention (``ops.attn_probes``), which is the hybrid
  kernels' plain version, against ``kern_hybrid`` (``hybrid_attn``) and
  ``kern_hybrid2`` (``hybrid2_attn``), at D 48 and a ragged D 40.

The probe file is loaded as it stands. Only the loaded copy changes: its
``pl`` becomes a namespace whose ``pallas_call`` runs in interpret mode and
keeps each callable it builds (the statistics and transpose bodies are built
inside timing functions), its size constants are cut down, its ``_time`` does
nothing, and the two JAX cache settings its import changes are put back.
Every JAX result comes from one jitted function."""

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
from eo_diffusion_torch.ops import softmax_probes as SP
from eo_diffusion_torch.tools import probe_softmax_orient
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
# relative to max|reference|: f32 sums in another order
REL = 1e-5
BH, BQ, BK = 2, 16, 32  # the probe's 64 cells of [512, 2048], cut down
RAGGED = (12, 37)       # a cell that fits no tile
B, H, T = 1, 2, 64
BLOCK_Q, BLOCK_K = 16, 32  # the hybrids' 512 and 2048
# the statistics cells: (name, axis, cell)
STATS = [("rows", 1, (BQ, BK)), ("cols", 0, (BK, BQ)), ("rows-ragged", 1, RAGGED),
         ("cols-ragged", 0, RAGGED[::-1])]
TRANSPOSES = [("probe", (BQ, BK)), ("ragged", RAGGED)]


@pytest.fixture(scope="module")
def probe():
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_probe_softmax_orient", ROOT / "tools" / "probe_softmax_orient.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    built = []

    def pallas_call(*args, **kwargs):
        f = pl.pallas_call(*args, interpret=True, **kwargs)
        built.append(f)
        return f

    mod.pl = types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec)
    mod.BH, mod.NQ, mod.REPS = BH, 2, 1
    mod._time = lambda *args, **kwargs: 0.0
    assert mod.NK == SP.NK
    mod.built = built
    return mod


def _body(probe, build):
    """The Pallas callable one of the probe's timing functions builds."""
    n = len(probe.built)
    build()
    assert len(probe.built) == n + 1
    return probe.built[-1]


@pytest.fixture(scope="module")
def results(probe):
    """Inputs and every JAX result (one jitted function)."""
    stats = [_body(probe, functools.partial(probe.bench_reduce, name, axis, cell))
             for name, axis, cell in STATS]
    transposes = []
    for _, (bq, bk) in TRANSPOSES:
        probe.BQ, probe.BK = bq, bk  # bench_transpose's block is the module's [BQ, BK]
        transposes.append(_body(probe, probe.bench_transpose))
    rng = np.random.default_rng(0)
    s = [rng.normal(size=(BH,) + cell).astype(np.float32) for _, _, cell in STATS]
    p = [rng.normal(size=(BH,) + cell).astype(np.float32) for _, cell in TRANSPOSES]
    qkv5 = [rng.normal(size=(B, 3, H, T, d)).astype(np.float32) for d in (48, 40)]
    for x in qkv5:
        x[:, :2] *= 2.0  # a sharper softmax than unit inputs

    def everything(s, p, qkv5):
        return ([f(x) for f, x in zip(stats, s)], [f(x) for f, x in zip(transposes, p)],
                [(probe.hybrid_attn(x, block_q=BLOCK_Q, block_k=BLOCK_K),
                  probe.hybrid2_attn(x, block_q=BLOCK_Q, block_k=BLOCK_K)) for x in qkv5])

    out = jax.jit(everything)(*jax.tree_util.tree_map(jnp.asarray, (s, p, qkv5)))
    j_stats, j_t, j_hyb = jax.tree_util.tree_map(np.asarray, out)
    return {"s": s, "p": p, "qkv5": qkv5, "stats": j_stats, "transposes": j_t, "hybrids": j_hyb}


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return (got - torch.tensor(want)).abs().max().item() / np.abs(want).max()


@pytest.mark.parametrize("i", range(len(STATS)), ids=[n for n, _, _ in STATS])
def test_softmax_stats_match_the_pallas_body(results, i):
    _, axis, cell = STATS[i]
    s = torch.tensor(results["s"][i])
    got = SP.softmax_stats_reference(s, axis)
    want = results["stats"][i]
    assert got.shape == want.shape == ((BH, cell[0], 1) if axis else (BH, 1, cell[1]))
    assert got.dtype == torch.float32 and _rel(got, want) <= REL
    assert torch.equal(SP.softmax_stats(s, axis), got)  # CPU: the plain version


@pytest.mark.parametrize("i", range(len(TRANSPOSES)), ids=[n for n, _ in TRANSPOSES])
def test_transpose_matches_the_pallas_body_bit_for_bit(results, i):
    p = torch.tensor(results["p"][i])
    got = SP.transpose_accumulate_reference(p)
    want = results["transposes"][i]
    assert got.shape == want.shape == (BH,) + TRANSPOSES[i][1][::-1]
    assert torch.equal(got, torch.tensor(want))
    assert torch.equal(SP.transpose_accumulate(p), got)


@pytest.mark.parametrize("d_i", [0, 1], ids=["d48", "d40"])
@pytest.mark.parametrize("variant", list(AP.HYBRIDS))
def test_hybrid_plain_version_matches_kern_hybrid(results, d_i, variant):
    qkv5 = torch.tensor(results["qkv5"][d_i])
    got = AP.hybrid_attention(qkv5, variant)  # CPU: the plain version
    want = results["hybrids"][d_i][list(AP.HYBRIDS).index(variant)]
    assert got.shape == want.shape == (B, H, qkv5.shape[-1], T)
    assert torch.equal(got, AP.transposed_attention_reference(qkv5))
    assert _rel(got, want) <= REL


def test_plain_stats_of_both_orientations_agree():
    """The statistics of s along its rows are those of sᵀ along its columns."""
    s = torch.tensor(np.random.default_rng(1).normal(size=(3, 7, 50)).astype(np.float32))
    rows = SP.softmax_stats_reference(s, 1)
    cols = SP.softmax_stats_reference(s.mT.contiguous(), 0)
    assert torch.allclose(rows.mT, cols, rtol=1e-6, atol=0)
    m = s.amax(-1, keepdim=True)
    assert torch.allclose(rows, SP.NK * (m + torch.exp(s - m).sum(-1, keepdim=True)), rtol=1e-6)


def test_the_tools_bounds():
    """The port's tool prices the probe's shapes as the bytes they move."""
    bh, m, n = (probe_softmax_orient.B * probe_softmax_orient.H, probe_softmax_orient.BQ,
                probe_softmax_orient.BK)
    ms, by = probe_softmax_orient.stats_bound_ms(bh, m, n, 1)
    assert by == "bytes" and abs(ms - 0.0801) < 1e-4
    ms, by = probe_softmax_orient.transpose_bound_ms(bh, m, n)
    assert by == "bytes" and abs(ms - 0.1202) < 1e-4


def test_entries_and_refusals():
    s = torch.ones(2, 4, 8)
    before = (SP.softmax_stats_cuda.launches, SP.transpose_accumulate_cuda.launches,
              AP.hybrid_attention_cuda.launches)
    assert torch.equal(SP.softmax_stats(s, 1), torch.full((2, 4, 1), 2 * (1.0 + 8.0)))
    assert torch.equal(SP.transpose_accumulate(s.bfloat16()), torch.full((2, 8, 4), 2.0))
    qkv5 = torch.zeros(1, 3, 2, 10, 16)
    assert torch.equal(AP.hybrid_attention(qkv5, "hybrid"), torch.zeros(1, 2, 16, 10))
    assert (SP.softmax_stats_cuda.launches, SP.transpose_accumulate_cuda.launches,
            AP.hybrid_attention_cuda.launches) == before
    for call in (lambda: SP.softmax_stats_cuda(s, 1), lambda: SP.transpose_accumulate_cuda(
            s.bfloat16()), lambda: AP.hybrid_attention_cuda(qkv5.bfloat16())):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="axis"):
        SP.softmax_stats(s, 2)
    with pytest.raises(ValueError, match="cells"):
        SP.transpose_accumulate(s[0])
    with pytest.raises(ValueError, match="variant"):
        AP.hybrid_attention(qkv5, "hybrid3")
    with pytest.raises(ValueError, match="block_k"):
        AP.hybrid_attention(torch.zeros(1, 3, 2, 10, 96), "hybrid", 128)  # 128 keys: D <= 64
    with pytest.raises(ValueError, match="device meta"):
        SP.softmax_stats(s.to("meta"), 1)
    with pytest.raises(ValueError, match="device meta"):
        SP.transpose_accumulate(s.to("meta"))
    with pytest.raises(ValueError, match="device meta"):
        AP.hybrid_attention(qkv5.to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            probe_softmax_orient.run()
