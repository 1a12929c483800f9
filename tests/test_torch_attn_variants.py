"""The port's attention-variant probes (eo_diffusion_torch.ops.attn_variants)
against the JAX package's experiments on the CPU:

* the plain variants A-D against ``kern_A`` ... ``kern_D`` as
  ``tools/profile_attn_variants.py``'s ``run`` wraps them (q and k scaled,
  folded, D padded to 128), in f32 at two q tiles and at a ragged shape (D
  40, T 48), and in bf16, where the points at which A, B and D round p
  change the output, and with scores large enough that D's missing max
  overflows;
* variant B against ``kern_chunked`` as ``tools/profile_attn_variants2.py``'s
  ``run`` wraps it, at three (q tile, KV chunk) pairs;
* the fused-layout route's plain version against ``fused_layout_attn``
  (``tools/profile_attn_fusedlayout.py``).

The tool files are loaded as they stand. Only the loaded copies change: their
``pl`` becomes a namespace whose ``pallas_call`` runs in interpret mode, their
size constants are cut down, and (for the two ``run`` functions, which build
their jitted function around the kernel and time it) their ``jax.jit`` stops
``run`` at once and hands back the function it was given, whose closure
holds the wrapped kernel ``f``. The two JAX cache settings an import changes
are put back. Every JAX result comes from one jitted function."""

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

from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.ops import attn_variants as AV
from eo_diffusion_torch.tools import (profile_attn_fusedlayout, profile_attn_variants,
                                      profile_attn_variants2)
from eo_diffusion_torch.tools.probe_packed_pv import attention_errors, planted_faults
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
# relative to max|reference|: f32 sums in another order
REL = 1e-5
SHAPES = {"main": (1, 64, 2, 48), "ragged": (2, 48, 1, 40)}  # [B, T, H, D]
# (variant, q tile, shape): the JAX tool's 512 and 1024 rows, cut down
CASES = ([(v, 32, "main") for v in "ABCD"] + [("B", 16, "main")]
         + [(v, 16, "ragged") for v in "ABCD"])
# (q tile, KV chunk) of kern_chunked: the JAX sweep's bq < bk, bq = bk, bq > bk
CHUNKS = [(16, 64), (32, 32), (64, 16)]
FUSED = [("main", 32, 32), ("ragged", 16, 16)]  # (shape, block_q, block_k)
# bf16, as the probes run on the card, on the "main" planes: the plain version
# rounds where the JAX kernel rounds, so the two differ only by exp's last bits
# and the order of f32 sums, where they tip a rounding of p or of the output
# (readings <= 1.3e-4 relative L2 at T 128); A, B and D round p at different
# points and sit about 3e-3 apart, so a plain A or D that took B's path fails
REL_BF16 = 5e-4
# q scaled by this on the "main" planes: scores reach hundreds, so exp(s)
# overflows f32 in some rows without the max (D) and in none with it (B)
HOT = 40.0


class _Stop(Exception):
    pass


class _JitStops:
    """``jax`` for a loaded tool, except that ``jit`` raises ``_Stop`` with the
    function it was given instead of compiling and timing it."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **_):
        def stop(*args, **kwargs):
            raise _Stop(fn)
        return stop


def _load(name):
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)
    mod.B, mod.T, mod.H, mod.D, mod.REPS = 1, 16, 1, 8, 1  # run's own inputs, never used
    return mod


def _wrapped_kernel(mod, *args):
    """The ``f`` that ``mod.run(*args)`` builds around its Pallas call."""
    jit, mod.jax = mod.jax, _JitStops()
    try:
        mod.run(*args)
    except _Stop as stop:
        chained = stop.args[0]
    else:
        raise AssertionError("run did not reach jax.jit")
    finally:
        mod.jax = jit
    cells = dict(zip(chained.__code__.co_freevars, (c.cell_contents for c in chained.__closure__)))
    return cells["f"]


@pytest.fixture(scope="module")
def results():
    """Inputs and every JAX result (one jitted function)."""
    variants, chunked, fused = (_load(n) for n in (
        "profile_attn_variants", "profile_attn_variants2", "profile_attn_fusedlayout"))
    fs = [_wrapped_kernel(variants, getattr(variants, f"kern_{v}"), bq) for v, bq, _ in CASES]
    fc = [_wrapped_kernel(chunked, bq, bk) for bq, bk in CHUNKS]

    fb = {v: fs[CASES.index((v, 32, "main"))] for v in "ABCD"}
    rng = np.random.default_rng(0)
    qkv = {name: rng.normal(size=(b, t, 3, h, d)).astype(np.float32)
           for name, (b, t, h, d) in SHAPES.items()}
    qkv["hot"] = qkv["main"].copy()
    qkv["hot"][:, :, 0] *= HOT

    def everything(qkv):
        planes = {n: (x[:, :, 0], x[:, :, 1], x[:, :, 2]) for n, x in qkv.items()}
        bf16 = {n: tuple(x.astype(jnp.bfloat16) for x in planes[n]) for n in ("main", "hot")}
        return ([f(*planes[shape]) for f, (_, _, shape) in zip(fs, CASES)],
                [f(*planes["main"]) for f in fc],
                [fused.fused_layout_attn(qkv[shape], block_q=bq, block_k=bk)
                 for shape, bq, bk in FUSED],
                {v: f(*bf16["main"]).astype(jnp.float32) for v, f in fb.items()},
                fb["D"](*bf16["hot"]).astype(jnp.float32))

    out = jax.jit(everything)({n: jnp.asarray(x) for n, x in qkv.items()})
    j_var, j_chunk, j_fused, j_bf16, j_hot = jax.tree_util.tree_map(np.asarray, out)
    return {"qkv": qkv, "variants": j_var, "chunked": j_chunk, "fused": j_fused,
            "bf16": j_bf16, "hot": j_hot}


def _planes(results, shape, dtype=torch.float32):
    x = torch.tensor(results["qkv"][shape]).to(dtype)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def _rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    want = torch.tensor(want)
    return ((got.float() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return (got - torch.tensor(want)).abs().max().item() / np.abs(want).max()


@pytest.mark.parametrize("i", range(len(CASES)), ids=[f"{v}-bq{bq}-{s}" for v, bq, s in CASES])
def test_variant_matches_the_pallas_kernel(results, i):
    variant, _, shape = CASES[i]
    q, k, v = _planes(results, shape)
    got = AV.attention_variant_reference(q, k, v, variant)
    want = results["variants"][i]
    assert got.shape == want.shape == q.shape and got.dtype == torch.float32
    assert _rel(got, want) <= REL
    assert torch.equal(AV.attention_variant(q, k, v, variant), got)  # CPU: the plain version


@pytest.mark.parametrize("variant", "ABCD")
def test_variant_in_bf16_rounds_where_the_pallas_kernel_rounds(results, variant):
    q, k, v = _planes(results, "main", torch.bfloat16)
    got = AV.attention_variant_reference(q, k, v, variant)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, results["bf16"][variant]) <= REL_BF16
    for other in "ABCD".replace(variant, ""):  # each other kernel's rounding is told apart
        assert _rel_l2(got, results["bf16"][other]) > REL_BF16, other


def test_variant_d_without_the_max_overflows_where_the_pallas_kernel_does(results):
    q, k, v = _planes(results, "hot", torch.bfloat16)
    assert torch.isfinite(AV.attention_variant_reference(q, k, v, "B")).all()
    d = AV.attention_variant_reference(q, k, v, "D").float()
    want = torch.tensor(results["hot"])
    nan = d.isnan()
    assert 0 < nan.float().mean() < 1  # some rows overflow, not all
    assert torch.equal(nan, want.isnan())
    assert torch.equal(d.isinf(), want.isinf()) and torch.equal(d[d.isinf()], want[want.isinf()])
    fin = d.isfinite()
    assert _rel_l2(d[fin], want[fin].numpy()) <= REL_BF16


@pytest.mark.parametrize("i", range(len(CHUNKS)), ids=[f"bq{a}-bk{b}" for a, b in CHUNKS])
def test_chunked_is_variant_b(results, i):
    q, k, v = _planes(results, "main")
    assert _rel(AV.attention_variant_reference(q, k, v, "B"), results["chunked"][i]) <= REL


@pytest.mark.parametrize("i", range(len(FUSED)), ids=[s for s, _, _ in FUSED])
def test_fused_layout_matches_fused_layout_attn(results, i):
    qkv = torch.tensor(results["qkv"][FUSED[i][0]])
    got = AV.fused_layout_attention(qkv)  # CPU: the plain version
    want = results["fused"][i]
    assert got.shape == want.shape == qkv[:, :, 0].shape
    assert _rel(got, want) <= REL
    # K1's function in the new head order: the fused projection [B, T, 3C]
    b, t, _, h, d = qkv.shape
    by_qkv = A.attention_from_qkv(qkv.reshape(b, t, 3 * h * d), h, new_order=True, impl="plain")
    assert torch.equal(by_qkv.reshape(b, t, h, d), got)


def test_b_is_the_ports_attention_and_a_agrees_in_f32():
    """B is K1's function; in f32 (no rounding of p) A computes it too, and D
    as well while the scores stay small."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(rng.normal(size=(2, 20, 3, 16)).astype(np.float32)) for _ in range(3))
    b = AV.attention_variant_reference(q, k, v, "B")
    assert torch.allclose(b, A.reference_attention(q, k, v), rtol=1e-5, atol=1e-6)
    for other in "AD":
        assert torch.allclose(AV.attention_variant_reference(q, k, v, other), b, rtol=1e-4,
                              atol=1e-5)


def test_the_card_limits_sit_between_rounding_and_the_planted_faults():
    """chip_smoke.py holds the attention probes, by ``attention_errors``, to TOL
    of max(rms, |plain|) and TOL_ATTN_L2. At the ragged shape's unit-normal
    inputs, p rounded to bf16 at no point against every point (how K1 stands
    to its plain version) reads inside both limits, and each fault the tools
    plant reads outside one."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    tol, tol_l2 = cs.TOL[torch.bfloat16], cs.TOL_ATTN_L2[torch.bfloat16]
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.normal(size=(1, 1000, 2, 40)).astype(np.float32)).bfloat16()
               for _ in range(3))
    b = AV.attention_variant_reference(q, k, v, "B")
    rounding = attention_errors(b, A.reference_attention(q, k, v))
    assert 0 < rounding["max_rms_scaled_err"] <= tol and rounding["rel_l2_err"] <= tol_l2
    drop = profile_attn_variants.without_a_stage
    assert drop(k).shape == (1, 1000 - profile_attn_variants.STAGE, 2, 40)
    faults = planted_faults(b, b, AV.attention_variant_reference(q, drop(k), drop(v), "B"))
    assert faults["scaled_1pct"]["rel_l2_err"] > tol_l2
    assert faults["stage_dropped"]["max_rms_scaled_err"] > tol
    assert faults["stage_dropped"]["rel_l2_err"] > tol_l2


def test_the_tools_tiles_and_bounds():
    assert profile_attn_variants.TILES[0] == AV.K1_TILE
    assert all(t in AV.TILES[v] for t in profile_attn_variants.TILES for v in AV.VARIANTS)
    assert set(profile_attn_variants2.SWEEP) == set(AV.TILES["B"])
    assert AV.K1_TILE in profile_attn_variants2.SWEEP
    for tool in (profile_attn_variants, profile_attn_fusedlayout):
        assert (tool.B, tool.T, tool.H, tool.D) == (8, 4096, 8, 48)


def test_entries_and_refusals():
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.normal(size=(1, 10, 2, 16)).astype(np.float32)) for _ in range(3))
    before = (AV.attention_variant_cuda.launches, A.qkv_attention_cuda.launches)
    assert torch.equal(AV.attention_variant(q, k, v, "C", warps=8),
                       AV.attention_variant_reference(q, k, v, "C"))
    assert torch.equal(AV.attention_variant(q, k, v, "B", warps=16, block_k=128),
                       AV.attention_variant_reference(q, k, v, "B"))
    qkv = torch.stack([q, k, v], dim=2)
    assert torch.equal(AV.fused_layout_attention(qkv), A.reference_attention(q, k, v))
    assert (AV.attention_variant_cuda.launches, A.qkv_attention_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        AV.attention_variant_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16(), "B")
    with pytest.raises(ValueError, match="variant"):
        AV.attention_variant(q, k, v, "E")
    with pytest.raises(ValueError, match="warps, block_k"):
        AV.attention_variant(q, k, v, "C", warps=16)  # the 16-warp tiles are B's
    with pytest.raises(ValueError, match="shape"):
        AV.attention_variant(q, k[:, :5], v, "A")
    with pytest.raises(ValueError, match=r"\[B, T, 3, H, D\]"):
        AV.fused_layout_attention(q)
    with pytest.raises(ValueError, match="device meta"):
        AV.attention_variant(q.to("meta"), k.to("meta"), v.to("meta"), "B")
    with pytest.raises(ValueError, match="device meta"):
        AV.fused_layout_attention(qkv.to("meta"))
    if not torch.cuda.is_available():
        for tool in (profile_attn_variants, profile_attn_variants2, profile_attn_fusedlayout):
            with pytest.raises(SystemExit, match="CUDA"):
                tool.run()
