"""The port's token merging (eo_diffusion_torch.ops.tome) and ToMe DiT
against the JAX package's, f32 on the CPU, from one jitted JAX function:
``build_merge`` at r = 0 and r > 0 on a metric with tied scores (duplicate
tokens), and a tiny DiT forward with ``tome_ratio`` and ``tome_mlp``."""

import jax
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.ops import tome as TT
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params
from eo_diffusion_tpu.models import dit as JD
from eo_diffusion_tpu.ops import tome as JT
from torch_parity import one_torch_thread, random_dit_params, rel_err  # noqa: F401

REL_TOL = 1e-5
GRID = (4, 6)  # 24 tokens: 6 dst, 18 src
RS = (0, 5, 18)
DIT = dict(image_size=32, in_channels=3, out_channels=3, patch_size=4, hidden_size=64,
           depth=2, num_heads=4, tome_ratio=0.375, tome_mlp=True)


def _tied_metric(rng):
    """[2, 24, 8] with ties: tokens 3, 5, 9 and 13 the same vector (equal
    scores), dst tokens 0 and 2 the same (equal similarities, the first
    maximum wins)."""
    m = rng.normal(size=(2, 24, 8)).astype(np.float32)
    m[:, [5, 9, 13]] = m[:, 3:4]
    m[:, 2] = m[:, 0]
    return m


@pytest.fixture(scope="module")
def twin():
    rng = np.random.default_rng(0)
    metric = _tied_metric(rng)
    x = rng.normal(size=(2, 24, 5)).astype(np.float32)
    jmodel, params = random_dit_params(JD.DiTConfig(**DIT), seed=7)
    xd = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    t = np.array([999.0, 123.4], np.float32)

    @jax.jit
    def run(params, metric, x, xd, t):
        outs = []
        for r in RS:
            merge, unmerge = JT.build_merge(metric, GRID, r)
            m = merge(x)
            outs.append((m, unmerge(m)))
        return outs, jmodel.apply(params, xd, t)

    ref = jax.tree.map(np.asarray, run(params, metric, x, xd, t))
    return dict(metric=metric, x=x, xd=xd, t=t, params=params, ref=ref)


def test_partition_and_merge_count_match_jax():
    for grid in ((4, 6), (32, 32), (5, 3)):
        for a, b in zip(TT.tome_partition(*grid), JT.tome_partition(*grid)):
            np.testing.assert_array_equal(a, b)
    for tokens, ratio in ((1024, 0.375), (1024, 0.5), (4096, 0.3), (16, 0.375), (24, 0.9)):
        n_src = len(TT.tome_partition(int(tokens ** 0.5), int(tokens ** 0.5))[1]) \
            if int(tokens ** 0.5) ** 2 == tokens else 18
        assert (TT.aligned_merge_count(tokens, n_src, ratio)
                == JT.aligned_merge_count(tokens, n_src, ratio))
    assert 1024 - TT.aligned_merge_count(1024, 768, 0.375) == 640  # dit256's merged T


@pytest.mark.parametrize("i", range(len(RS)))
def test_build_merge_matches_jax(twin, i):
    """merge and unmerge at r = 0 (a permutation round trip), r = 5 and r =
    18 (every src token), on tied scores: the same tokens merge into the
    same dst."""
    merge, unmerge = TT.build_merge(torch.from_numpy(twin["metric"]), GRID, RS[i])
    m = merge(torch.from_numpy(twin["x"]))
    want_m, want_u = twin["ref"][0][i]
    assert m.shape == want_m.shape and rel_err(m, want_m) <= REL_TOL
    u = unmerge(m)
    assert u.shape == want_u.shape and rel_err(u, want_u) <= REL_TOL
    if RS[i] == 0:
        assert torch.equal(u, torch.from_numpy(twin["x"]))


def test_merge_carries_gradients():
    """merge / unmerge are differentiable (ToMe training): the gradient of a
    sum through both is the count of each token's uses."""
    rng = np.random.default_rng(1)
    metric = torch.from_numpy(_tied_metric(rng))
    merge, unmerge = TT.build_merge(metric, GRID, 5)
    x = torch.from_numpy(rng.normal(size=(2, 24, 5)).astype(np.float32)).requires_grad_()
    unmerge(merge(x)).sum().backward()
    assert x.grad.shape == x.shape and bool(torch.isfinite(x.grad).all())
    assert float(x.grad.sum()) == pytest.approx(2 * 24 * 5, rel=1e-5)


def test_tome_dit_matches_jax(twin):
    """A ToMe DiT (T 64, ratio 0.375, around the MLP too): forward."""
    cfg = TD.DiTConfig(**DIT)
    assert cfg.tome_r == 24 and cfg.tokens - cfg.tome_r == 40
    model = TD.DiT(cfg)
    model.load_state_dict(dit_state_dict_from_jax_params(twin["params"], cfg), strict=True)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(twin["xd"]), torch.from_numpy(twin["t"]))
    want = twin["ref"][1]
    assert np.abs(want).max() > 0.1 and rel_err(out, want) <= REL_TOL
