"""The port's guidance points against the JAX package's (f32, CPU):
``cfg_double_inputs`` / ``cfg_combine`` (with the CFG-rescale),
``interval_scale``, ``apply_dynamic_threshold``, the autoguidance combine,
and ``sdedit_plan`` / ``sdedit_sample`` on a DDIM tail and a flow tail with a
closed-form denoiser written once in jnp and once in torch. Inputs come from
a numpy seed; the JAX functions run eagerly, and SDEdit's two samplers are
its only compiled programs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion import autoguide as TA
from eo_diffusion_torch.diffusion import edit as TE
from eo_diffusion_torch.diffusion import gaussian as TG
from eo_diffusion_torch.diffusion.flow import FlowMatching as TFM
from eo_diffusion_tpu.diffusion import autoguide as JA
from eo_diffusion_tpu.diffusion import edit as JE
from eo_diffusion_tpu.diffusion import gaussian as JG
from eo_diffusion_tpu.diffusion.flow import FlowMatching as JFM
from torch_parity import one_torch_thread, rel_err  # noqa: F401

# the guidance points are elementwise f32 maths and f32 reductions over a
# sample: max |port - jax| / max |jax|
GUIDE_TOL = 1e-6
# SDEdit tails: whole f32 trajectories (DESIGN.md:52-54)
TRAJ_TOL = 5e-5
SHAPE = (3, 6, 5, 4)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("mode", ["image", "label", "both", "off"])
def test_cfg_double_inputs_matches_jax(mode):
    x, c, u = _arrays(0, SHAPE, SHAPE, SHAPE)
    t = np.array([5, 9, 1], np.int32)
    y, yu = np.array([0, 2, 1]), np.array([3, 3, 3])
    kw = {"image": dict(uncond=u), "label": dict(y_uncond=yu), "both": dict(uncond=u, y_uncond=yu),
          "off": dict(uncond=u)}[mode]
    scale = 1.0 if mode == "off" else 3.0
    want = JG.cfg_double_inputs(jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), jnp.asarray(y),
                                guidance_scale=scale, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = TG.cfg_double_inputs(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c),
                               torch.from_numpy(y), guidance_scale=scale,
                               **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got[-1] == want[-1] == (mode != "off")
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_cfg_combine_matches_jax(rescale):
    (out,) = _arrays(1, (6,) + SHAPE[1:])
    want = JG.cfg_combine(jnp.asarray(out), 4.5, rescale)
    got = TG.cfg_combine(torch.from_numpy(out), 4.5, rescale)
    assert rel_err(got, want) <= GUIDE_TOL
    # the interval's 0-dim float32 scale combines the same way
    scale = TG.interval_scale(4.5, torch.tensor(0.5), (0.2, 0.8))
    assert rel_err(TG.cfg_combine(torch.from_numpy(out), scale, rescale), want) <= GUIDE_TOL


@pytest.mark.parametrize("frac", [0.0, 0.19999, 0.2, 0.5, 0.8, 0.80001, 1.0])
def test_interval_scale_matches_jax(frac):
    want = float(JG.interval_scale(3.0, frac, (0.2, 0.8)))
    assert TG.interval_scale(3.0, frac, (0.2, 0.8)) == want
    assert float(TG.interval_scale(3.0, torch.tensor(frac), (0.2, 0.8))) == want
    assert TG.interval_scale(3.0, frac, None) == 3.0


@pytest.mark.parametrize("percentile,scale", [(0.995, 3.0), (0.9, 1.5), (1.0, 4.0), (0.6, 0.5)])
def test_dynamic_threshold_matches_jax(percentile, scale):
    (x0,) = _arrays(2, (3, 7, 9, 3))
    x0 = x0 * scale  # 0.5: every sample in range, the identity
    want = JG.apply_dynamic_threshold(jnp.asarray(x0), percentile)
    got = TG.apply_dynamic_threshold(torch.from_numpy(x0), percentile)
    assert rel_err(got, want) <= GUIDE_TOL


@pytest.mark.parametrize("interval,rescale", [(None, 0.0), ((0.1, 0.6), 0.7)])
def test_autoguide_combine_matches_jax(interval, rescale):
    x, c = _arrays(3, SHAPE, SHAPE)
    main = lambda m: (lambda x, t, c, y: 0.8 * x + 0.1 * c)
    bad = lambda m: (lambda x, t, c, y: 0.5 * x - 0.2 * c)
    for t in (np.array([10, 10, 10]), np.array([90, 90, 90])):  # inside / outside
        want = JA.autoguided_model_fn(main(jnp), bad(jnp), 2.5, rescale, interval, 100)(
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), None)
        got = TA.autoguided_model_fn(main(torch), bad(torch), 2.5, rescale, interval, 100)(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c), None)
        assert got.dtype == torch.float32 and rel_err(got, want) <= GUIDE_TOL
    # flow: the gate reads t / time_scale through noise_frac_fn
    nf = lambda t: t[0] / 1000.0
    t = np.full((3,), 400.0, np.float32)
    want = JA.autoguided_model_fn(main(jnp), bad(jnp), 2.5, rescale, interval,
                                  noise_frac_fn=nf)(jnp.asarray(x), jnp.asarray(t),
                                                    jnp.asarray(c), None)
    got = TA.autoguided_model_fn(main(torch), bad(torch), 2.5, rescale, interval,
                                 noise_frac_fn=nf)(torch.from_numpy(x), torch.from_numpy(t),
                                                   torch.from_numpy(c), None)
    assert rel_err(got, want) <= GUIDE_TOL


@pytest.mark.parametrize("steps,strength", [(50, 0.5), (10, 0.04), (10, 1.0), (7, 0.3)])
def test_sdedit_plan_matches_jax(steps, strength):
    assert TE.sdedit_plan(steps, strength) == JE.sdedit_plan(steps, strength)


def _eps(lib):
    return lambda x, t, c, y: 0.3 * x + lib.sin(x) * (t / 1000.0)[:, None, None, None] + 0.1 * c


def test_sdedit_sample_matches_jax():
    """The DDIM tail (start_index = k) with image-CFG, and the Heun tail of a
    flow, from the same source and eps (the JAX sampler's first key)."""
    src, c = _arrays(4, (2, 8, 8, 3), (2, 8, 8, 3))
    key = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(jax.random.split(key)[0], src.shape, jnp.float32))
    jd = JG.GaussianDiffusion.create(timesteps=100, image_size=8, in_channels=3)
    td = TG.GaussianDiffusion.create(timesteps=100, image_size=8, in_channels=3)
    gkw = dict(guidance_scale=2.0, guidance_rescale=0.5)
    want = JE.sdedit_sample(jd, _eps(jnp), key, jnp.asarray(src), 0.5, num_steps=10,
                            cond=jnp.asarray(c), uncond=jnp.zeros_like(jnp.asarray(c)), **gkw).x
    got = TE.sdedit_sample(td, _eps(torch), torch.from_numpy(src), 0.5, device="cpu",
                           num_steps=10, noise=torch.from_numpy(eps), cond=torch.from_numpy(c),
                           uncond=torch.zeros(2, 8, 8, 3), **gkw).x
    assert rel_err(got, want) <= TRAJ_TOL
    vel = lambda lib: (lambda x, t, c, y: 0.5 * x - lib.cos(x) * (t / 1000.0)[:, None, None, None])
    want = JE.sdedit_sample(JFM.create(image_size=8), vel(jnp), key, jnp.asarray(src), 0.6,
                            num_steps=5, method="heun").x
    calls = []
    counted = lambda x, t, c, y: calls.append(float(t[0])) or vel(torch)(x, t, c, y)
    got = TE.sdedit_sample(TFM.create(image_size=8), counted, torch.from_numpy(src), 0.6,
                           device="cpu", num_steps=5, method="heun",
                           noise=torch.from_numpy(eps)).x
    assert rel_err(got, want) <= TRAJ_TOL
    # k = 3 intervals from t = 0.6: two Heun steps and a last Euler step
    np.testing.assert_allclose(calls, [600, 400, 400, 200, 200], rtol=1e-6)
