"""ReFlow in the port (eo_diffusion_torch.diffusion.distill) against the JAX
package's ``diffusion/distill.py``, float32 on the CPU, on a closed-form
velocity field with labels: ``generate_couplings`` (Euler and Heun, a ragged
last chunk tiled to a full one, the labels sliced per chunk) with the JAX
chunks' noise injected, ``straightness``, ``endpoint_gap``, the guided
teacher of ``cfg_model_fn`` (with the rescale), and ``coupling_batches`` bit
for bit. The JAX side's chunks are ``generate_couplings``'s own body
(``FlowMatching.sample`` from ``normal(fold_in(rng, i))``) inside the file's
one jitted function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion import distill as TDS
from eo_diffusion_torch.diffusion.flow import FlowMatching as TFM
from eo_diffusion_tpu.diffusion import distill as JDS
from eo_diffusion_tpu.diffusion.flow import FlowMatching as JFM
from torch_parity import one_torch_thread, rel_err  # noqa: F401

REL_TOL = 1e-5
TRAJ_TOL = 5e-5
SIZE, N_PAIRS, BATCH, STEPS, NULL = 8, 6, 4, 5, 3
METHODS = ("euler", "heun")


def _velocity(lib):
    def fn(x, t, c=None, y=None):
        tt = (t.astype(jnp.float32) if lib is jnp else t.float()) / 1000.0
        out = 0.7 * x + lib.sin(x) * tt[:, None, None, None] - 0.1
        if y is not None:
            yy = y.astype(jnp.float32) if lib is jnp else y.float()
            out = out + 0.2 * yy[:, None, None, None] * (1.0 + 0.3 * x)
        return out
    return fn


@pytest.fixture(scope="module")
def ref():
    flow = JFM.create(image_size=SIZE, in_channels=3)
    rng = np.random.default_rng(2)
    y = np.array([0, 1, 2, 1, 0, 2], np.int32)
    eval_eps = rng.normal(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    eval_x1 = rng.normal(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    shape = (BATCH, SIZE, SIZE, 3)

    def run(y, eval_eps, eval_x1):
        out = {}
        guided = JDS.cfg_model_fn(_velocity(jnp), 2.5, NULL, guidance_rescale=0.6)
        for method in METHODS:
            eps_all, x1_all = [], []
            for i in range(-(-N_PAIRS // BATCH)):  # generate_couplings's chunk body
                k = jax.random.fold_in(key, i)
                yy = JDS._pad_to_batch(y[i * BATCH:(i + 1) * BATCH], BATCH)
                eps = jax.random.normal(k, shape, jnp.float32)
                x1 = flow.sample(guided, k, BATCH, num_steps=STEPS, method=method, x_T=eps,
                                 y=yy).x
                eps_all.append(eps)
                x1_all.append(x1)
            out[method] = (jnp.concatenate(eps_all)[:N_PAIRS], jnp.concatenate(x1_all)[:N_PAIRS])
        yv = y[:3]
        out["straightness"] = JDS.straightness(flow, _velocity(jnp), eval_eps, eval_x1, y=yv)
        for k in (1, 2):
            out[f"gap{k}"] = JDS.endpoint_gap(flow, _velocity(jnp), eval_eps, few_steps=k,
                                              ref_steps=6, y=yv)
        out["guided"] = guided(eval_eps, jnp.full((3,), 400.0), None, yv)
        return out

    out = jax.tree.map(np.asarray, jax.jit(run)(y, eval_eps, eval_x1))
    return dict(y=y, eval_eps=eval_eps, eval_x1=eval_x1), out


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("method", METHODS)
def test_generate_couplings_matches_jax(ref, method):
    d, out = ref
    eps, x1 = out[method]
    guided = TDS.cfg_model_fn(_velocity(torch), 2.5, NULL, guidance_rescale=0.6)
    got_eps, got_x1 = TDS.generate_couplings(
        TFM.create(image_size=SIZE, in_channels=3), guided, N_PAIRS, device="cpu",
        num_steps=STEPS, method=method, batch_size=BATCH, y=d["y"].astype(np.int64), eps=eps)
    assert got_eps.shape == got_x1.shape == (N_PAIRS, SIZE, SIZE, 3)
    assert np.array_equal(got_eps, eps)
    assert rel_err(got_x1, x1) <= TRAJ_TOL


def test_couplings_draw_their_own_noise():
    g = torch.Generator().manual_seed(0)
    eps, x1 = TDS.generate_couplings(TFM.create(image_size=SIZE, in_channels=3), _velocity(torch),
                                     5, device="cpu", generator=g, num_steps=2, batch_size=2)
    assert eps.shape == x1.shape == (5, SIZE, SIZE, 3) and np.isfinite(x1).all()
    assert abs(float(eps.std()) - 1.0) < 0.2


def test_straightness_and_endpoint_gap_match_jax(ref):
    d, out = ref
    flow = TFM.create(image_size=SIZE, in_channels=3)
    y = _t(d["y"][:3], torch.long)
    s = TDS.straightness(flow, _velocity(torch), _t(d["eval_eps"]), _t(d["eval_x1"]), y=y)
    assert abs(float(s) - float(out["straightness"])) <= REL_TOL * float(out["straightness"])
    for k in (1, 2):
        gap = TDS.endpoint_gap(flow, _velocity(torch), _t(d["eval_eps"]), few_steps=k,
                               ref_steps=6, y=y)
        assert abs(float(gap) - float(out[f"gap{k}"])) <= TRAJ_TOL * float(out[f"gap{k}"])


def test_cfg_model_fn_matches_jax(ref):
    d, out = ref
    guided = TDS.cfg_model_fn(_velocity(torch), 2.5, NULL, guidance_rescale=0.6)
    got = guided(_t(d["eval_eps"]), torch.full((3,), 400.0), None, _t(d["y"][:3], torch.long))
    assert rel_err(got, out["guided"]) <= REL_TOL
    with pytest.raises(AssertionError, match="labels"):
        guided(_t(d["eval_eps"]), torch.full((3,), 400.0))


@pytest.mark.parametrize("with_extras", [False, True])
def test_coupling_batches_match_jax_bit_for_bit(with_extras):
    rng = np.random.default_rng(5)
    eps, x1 = (rng.normal(size=(7, 4, 4, 3)).astype(np.float32) for _ in range(2))
    kw = dict(cond=rng.normal(size=(7, 4, 4, 2)).astype(np.float32),
              y=np.arange(7, dtype=np.int32)) if with_extras else {}
    got = TDS.coupling_batches(eps, x1, 3, seed=4, **kw)
    want = JDS.coupling_batches(eps, x1, 3, seed=4, **kw)
    for _ in range(5):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
