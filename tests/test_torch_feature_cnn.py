"""The port's FeatureCNN (eo_diffusion_torch.models.feature_cnn) against the
JAX package's on the CPU: ``gallery/eval_extractor64_smoke.npz`` loaded by
each package's ``load_params``, logits, raw and unit-RMS features on a
seeded batch (even and odd sizes, so the stride-2 SAME padding is held both
ways) within 1e-5 relative; ``.npz`` round trips both ways; a short training
run. One jitted JAX function."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import feature_cnn as T
from eo_diffusion_tpu.models import feature_cnn as J
from torch_parity import one_torch_thread  # noqa: F401

REL_TOL = 1e-5
SMOKE = os.path.join(os.path.dirname(__file__), "..", "gallery", "eval_extractor64_smoke.npz")


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def twin():
    tparams, meta = T.load_params(SMOKE)
    jparams, _ = J.load_params(SMOKE)
    cfg = J.FeatureCNNConfig(in_channels=3, widths=tuple(int(w) for w in meta["widths"]),
                             num_classes=int(meta["num_classes"]),
                             feature_dim=int(meta["widths"][-1]))
    model = J.FeatureCNN(cfg)

    @jax.jit
    def run(p, x):
        logits, feats = model.apply(p, x)
        return logits, feats, model.apply(p, x, features_only=True)

    rng = np.random.default_rng(0)
    xs = {s: rng.uniform(size=(3, s, s, 3)).astype(np.float32) for s in (64, 37)}
    ref = {s: [np.asarray(a) for a in run(jparams, jnp.asarray(x))] for s, x in xs.items()}
    return tparams, jparams, meta, xs, ref


def test_config_recovered_from_the_saved_tree(twin):
    tparams, _, meta, _, _ = twin
    cfg = T.config_from_params(tparams)
    assert cfg.widths == tuple(int(w) for w in meta["widths"]) == (16, 24)
    assert (cfg.in_channels, cfg.num_classes, cfg.feature_dim) == (3, 5, 24)


@pytest.mark.parametrize("size", [64, 37])
def test_logits_and_features_match_jax(twin, size):
    tparams, _, _, xs, ref = twin
    model = T.build_model(tparams)
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(xs[size]))
        unit = model(torch.from_numpy(xs[size]), features_only=True)
    for got, want in zip((logits, feats, unit), ref[size]):
        assert got.shape == want.shape and _rel(got, want) <= REL_TOL
    torch.testing.assert_close(unit.pow(2).mean(-1), torch.ones(3))  # unit RMS kept
    # make_extractor: the same features as numpy, in chunks
    got = T.make_extractor(tparams, batch=2)(xs[size])
    assert got.dtype == np.float32 and _rel(got, ref[size][2]) <= REL_TOL


def test_npz_round_trips_both_ways(twin, tmp_path):
    tparams, jparams, meta, xs, ref = twin
    # port -> JAX: the module's weights saved by the port load in JAX unchanged
    saved = T.params_from_state_dict(T.build_model(tparams))
    T.save_params(saved, str(tmp_path / "port.npz"), meta={"widths": meta["widths"]})
    jback, jmeta = J.load_params(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(jmeta["widths"], meta["widths"])
    flat_j = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jparams))
    back = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jback)))
    assert len(back) == len(flat_j)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(back[path], leaf)
    # JAX -> port: a file the JAX package saves gives the port the same features
    J.save_params(jparams, str(tmp_path / "jax.npz"), meta=dict(meta))
    tback, tmeta = T.load_params(str(tmp_path / "jax.npz"))
    assert str(tmeta["data"]) == str(meta["data"])
    assert _rel(T.make_extractor(tback)(xs[64]), ref[64][2]) <= REL_TOL


def test_two_stream_extractor_is_its_streams_l2_normalised(twin):
    tparams, _, _, _, _ = twin
    x = np.random.default_rng(1).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    out = T.make_two_stream_extractor(tparams, None, 16, tparams, None, 2)(x)
    tiles = x.reshape(2, 2, 16, 2, 16, 3).transpose(0, 1, 3, 2, 4, 5).reshape(8, 16, 16, 3)
    ext = T.make_extractor(tparams)
    tex = ext(tiles).reshape(2, 4, -1).mean(1)
    comp = ext(x.reshape(2, 16, 2, 16, 2, 3).mean((2, 4)))
    l2 = lambda f: f / np.linalg.norm(f, axis=-1, keepdims=True)
    np.testing.assert_allclose(out, np.concatenate([l2(tex), l2(comp)], -1), rtol=1e-6)


def test_training_learns_and_saves_a_loadable_tree(tmp_path):
    """Two classes told apart by brightness: a few AdamW steps lift the
    held-out accuracy; the tree saves and reloads into a working extractor."""
    rng = np.random.default_rng(2)
    labels = np.arange(40) % 2
    images = (rng.uniform(size=(40, 8, 8, 3)) * 0.3 + labels[:, None, None, None] * 0.7
              ).astype(np.float32)
    cfg = T.FeatureCNNConfig(widths=(8, 8), num_classes=2, feature_dim=8)
    params, acc = T.train_feature_extractor(images, labels, cfg, steps=30, batch_size=16,
                                            lr=1e-2, seed=0)
    assert acc == 1.0
    T.save_params(params, str(tmp_path / "e.npz"))
    feats = T.make_extractor(T.load_params(str(tmp_path / "e.npz"))[0])(images[:4])
    assert feats.shape == (4, 8) and np.isfinite(feats).all()
