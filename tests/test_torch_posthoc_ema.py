"""The port's post-hoc EMA (eo_diffusion_torch.train.posthoc_ema) against the
JAX package's: the sigma_rel / gamma maps, ``solve_weights`` and
``synthesize``, ``PowerEMA.update`` over a few steps, snapshots written by
the JAX ``PowerEMA`` read by the port (flax keystr keys through the weights
converter, a UNet's and a DiT's), the port's own snapshots, ``restore_latest``
and ``synthesize_from_dir``. The JAX tracks of the two backbones come from
one jitted function; the other JAX calls are eager and small."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.train import posthoc_ema as TP
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params, state_dict_from_jax_params
from eo_diffusion_tpu.models import dit as JD
from eo_diffusion_tpu.train import posthoc_ema as JP
from torch_parity import configs, one_torch_thread, random_dit_params, random_params  # noqa: F401

# f32 weighted sums and EMA steps: max |port - jax| / max |jax| per leaf
EMA_TOL = 1e-6
UNET = dict(image_size=8, in_channels=3, model_channels=8, out_channels=3, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1,), num_heads=1)
DIT = dict(image_size=8, in_channels=3, out_channels=3, patch_size=2, hidden_size=32, depth=1,
           num_heads=2, num_classes=3, class_dropout_prob=0.1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("sigma_rel", [0.02, 0.05, 0.1, 0.15, 0.28])
def test_gamma_maps_match_jax(sigma_rel):
    g = TP.sigma_rel_to_gamma(sigma_rel)
    assert g == JP.sigma_rel_to_gamma(sigma_rel)
    assert TP.gamma_to_sigma_rel(g) == JP.gamma_to_sigma_rel(g)
    assert abs(TP.gamma_to_sigma_rel(g) - sigma_rel) < 1e-9


def test_solve_weights_and_synthesize_match_jax():
    snaps = [(t, g) for t in (100.0, 400.0, 1000.0) for g in TP.DEFAULT_GAMMAS]
    for sr, tt in ((0.05, 1000.0), (0.08, 800.0), (0.12, 1000.0)):
        want = JP.solve_weights(snaps, JP.sigma_rel_to_gamma(sr), tt)
        np.testing.assert_array_equal(TP.solve_weights(snaps, TP.sigma_rel_to_gamma(sr), tt),
                                      want)
    rng = np.random.default_rng(0)
    trees = [{"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)} for _ in snaps]
    w = JP.solve_weights(snaps, JP.sigma_rel_to_gamma(0.08), 800.0)
    want = JP.synthesize([jax.tree.map(jnp.asarray, tr) for tr in trees], w)
    got = TP.synthesize([{k: torch.from_numpy(v) for k, v in tr.items()} for tr in trees], w)
    for k in ("a", "b"):
        assert got[k].dtype == torch.float32 and _rel(got[k], want[k]) <= EMA_TOL


def test_power_ema_update_matches_jax():
    rng = np.random.default_rng(1)
    params = [{"w": rng.normal(size=(6, 4)).astype(np.float32),
               "b": rng.normal(size=(4,)).astype(np.float32)} for _ in range(4)]
    jema, tema = JP.PowerEMA(), TP.PowerEMA()
    jtr = jema.init(jax.tree.map(jnp.asarray, params[0]))
    ttr = tema.init({k: torch.from_numpy(v) for k, v in params[0].items()})
    for step, p in enumerate(params):
        jtr = jema.update(jtr, jax.tree.map(jnp.asarray, p), jnp.asarray(step))
        ttr = tema.update(ttr, {k: torch.from_numpy(v) for k, v in p.items()}, step)
    for j, t in zip(jtr, ttr):
        for k in ("w", "b"):
            assert _rel(t[k], j[k]) <= EMA_TOL
    # step 0: beta = 0, the tracks are the params
    fresh = tema.update(tema.init({"w": torch.zeros(2)}), {"w": torch.ones(2)}, 0)
    assert all(torch.equal(tr["w"], torch.ones(2)) for tr in fresh)


@jax.jit
def _jax_tracks(params):
    """The JAX ``PowerEMA``'s tracks after steps 1 and 2 of a run that
    alternates the params with a scaled copy (the file's one jitted JAX
    function)."""
    ema = JP.PowerEMA()
    scaled = jax.tree.map(lambda a: 1.5 * a - 0.1, params)
    tracks, out = ema.init(params), []
    for step in range(3):
        tracks = ema.update(tracks, scaled if step % 2 else params, jnp.asarray(step))
        if step:
            out.append(tracks)
    return out


@pytest.mark.parametrize("backbone", ["unet", "dit"])
def test_jax_snapshots_load_into_the_port(tmp_path, backbone):
    """Snapshots written by the JAX ``PowerEMA`` (flax keystr keys) load as
    the port's state dict, and ``synthesize_from_dir`` gives the port's
    weights of the JAX synthesis."""
    if backbone == "unet":
        jcfg, tcfg = configs(**UNET)
        _, params = random_params(jcfg, seed=2)
        convert = state_dict_from_jax_params
    else:
        tcfg = TD.DiTConfig(**DIT)
        _, params = random_dit_params(JD.DiTConfig(**DIT), seed=3)
        convert = dit_state_dict_from_jax_params
    jema = JP.PowerEMA()
    snaps = _jax_tracks(params)
    for step, tracks in ((1, snaps[0]), (2, snaps[1])):
        jema.save_snapshots(str(tmp_path), jax.device_get(tracks), step)
    template = {k: torch.zeros_like(v) for k, v in convert(params, tcfg).items()}
    tree = TP.load_tree(str(tmp_path / "phema_00000002_g16.970562.npz"), template, tcfg)
    want = convert(jax.device_get(snaps[1][0]), tcfg)
    assert tree.keys() == want.keys()
    assert all(torch.equal(tree[k], want[k]) for k in want)
    # the JAX synthesis in numpy: its snapshots, its weights, f32 sums
    trees, meta = JP.load_snapshots(str(tmp_path), params)
    w = JP.solve_weights(meta, JP.sigma_rel_to_gamma(0.08), max(t for t, _ in meta))
    want = convert(jax.tree.map(lambda *ls: sum(np.float32(wi) * np.asarray(l)
                                                for wi, l in zip(w, ls)), *trees), tcfg)
    got = TP.synthesize_from_dir(str(tmp_path), template, 0.08, cfg=tcfg)
    assert max(_rel(got[k], want[k]) for k in want) <= EMA_TOL
    with pytest.raises(ValueError, match="cfg"):
        TP.load_tree(str(tmp_path / "phema_00000002_g16.970562.npz"), template)


def test_own_snapshots_round_trip_and_restore(tmp_path):
    rng = np.random.default_rng(4)
    params = {"a.weight": torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32)),
              "a.bias": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))}
    ema = TP.PowerEMA((10.0, 3.0))
    tracks, step = ema.restore_latest(str(tmp_path), params)
    assert step == -1 and all(torch.equal(tr["a.bias"], params["a.bias"]) for tr in tracks)
    for s in range(5):
        ema.update(tracks, {k: v * (s + 1) for k, v in params.items()}, s)
        if s in (1, 4):
            ema.save_snapshots(str(tmp_path), tracks, s)
    restored, step = TP.PowerEMA((10.0, 3.0)).restore_latest(str(tmp_path), params)
    assert step == 4
    assert all(torch.equal(r[k], t[k]) for r, t in zip(restored, tracks) for k in params)
    trees, meta = TP.load_snapshots(str(tmp_path), params)
    assert sorted(meta) == [(2.0, 3.0), (2.0, 10.0), (5.0, 3.0), (5.0, 10.0)]
    out = TP.synthesize_from_dir(str(tmp_path), params, 0.1)
    assert out.keys() == params.keys() and all(torch.isfinite(v).all() for v in out.values())
    with pytest.raises(AssertionError, match="no phema"):
        TP.load_snapshots(str(tmp_path / "empty"), params)
