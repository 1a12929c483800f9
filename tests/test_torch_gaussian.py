"""The port's schedules and samplers against eo_diffusion_tpu (f32, CPU).

The two packages draw random numbers differently, so the JAX package's own
draws (its per-step key splits) are replayed into the port through
``noise_fn``; deterministic paths (DDIM eta = 0) share ``x_T``. Guidance
and dynamic thresholding on the ancestral chain run on a closed-form
denoiser."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.core import schedules as TS
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_torch.diffusion.gaussian import repaint_op_sequence
from eo_diffusion_tpu.core import schedules as JS
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from torch_parity import (cached_denoiser, closed_form_denoiser, configs,  # noqa: F401
                          one_torch_thread, port_model, random_params, rel_err)

# whole-trajectory f32 sampler parity: max |port - jax| / max |jax|
# (DESIGN.md:52-54: ~4e-5 over a 25-step DDIM trajectory)
TRAJ_TOL = 5e-5
SHAPE = (2, 8, 8, 3)
UNET = dict(image_size=8, in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=2)


@pytest.mark.parametrize("schedule,timesteps", [("cosine_eo", 50), ("linear", 40)])
def test_schedule_tables_equal(schedule, timesteps):
    js, ts = JS.make_schedule(timesteps, schedule), TS.make_schedule(timesteps, schedule)
    for name in ("betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    # S=30 of T=40/50 takes the reference's off-by-one guard (T/S < 2)
    for method in ("uniform", "quad", "trailing"):
        for steps, eta in ((10, 0.0), (30, 0.7)):
            jd = JS.make_ddim_schedule(js, steps, eta, method)
            td = TS.make_ddim_schedule(ts, steps, eta, method)
            for name in ("timesteps", "alphas", "alphas_prev", "sigmas",
                         "sqrt_one_minus_alphas"):
                np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    np.testing.assert_array_equal(TS.rescale_zero_terminal_snr(js.betas),
                                  JS.rescale_zero_terminal_snr(js.betas))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs(**UNET)
    jmodel, params = random_params(jcfg, seed=11)
    tmodel = port_model(tcfg, params)
    jfn = jax.jit(lambda x, t, c, y: jmodel.apply(params, x, t, cond=c, y=y))

    def tfn(x, t, c, y):
        with torch.no_grad():
            return tmodel(x, t, cond=c, y=y)

    return jfn, tfn


def _x0_and_mask():
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-1, 1, size=SHAPE).astype(np.float32)
    mask = (rng.uniform(size=SHAPE[:3] + (1,)) > 0.5).astype(np.float32)
    return x0, mask


JUMPS = dict(jump_len=2, jump_n=2)  # RePaint resampling over T = 6
# label-CFG (the rescale, and the interval, whose edges 0.2 and 0.8 are
# levels t / (T - 1) of a T = 6 chain) and dynamic thresholding
LABEL_CFG = dict(y=np.array([0, 3], np.int32), y_uncond=np.array([4, 4], np.int32),
                 guidance_scale=2.5, guidance_rescale=0.5, guidance_interval=(0.2, 0.8),
                 dynamic_threshold=0.9)


def _label_cfg_kw(stateful):
    kw = dict(LABEL_CFG)
    if stateful:  # the doubled batch flows through the stateful denoiser
        kw["model_state"] = np.zeros((2 * SHAPE[0],) + SHAPE[1:], np.float32)
    return kw


@pytest.fixture(scope="module")
def jax_refs(models):
    """The JAX samplers' trajectories the tests below hold the port to, from
    one jitted function (one compile): DDIM eta 0 over the UNet without and
    with inpainting, RePaint jumps over the UNet, and ancestral DDPM with
    label-CFG and thresholding over the closed-form denoiser, plain and
    stateful."""
    jfn, _ = models
    x_T = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    x0, mask = _x0_and_mask()
    as_j = lambda kw: {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                       for k, v in kw.items()}

    @jax.jit
    def run(x_T, x0, mask):
        jd = JGD.create(timesteps=50, image_size=8, in_channels=3)
        out = {f"ddim_{inpaint}": jd.ddim_sample(
            jfn, jax.random.PRNGKey(2), 2, num_steps=10, x_T=x_T,
            mask=mask if inpaint else None, x0=x0 if inpaint else None).x
            for inpaint in (False, True)}
        jsum = JGD.create(timesteps=6, image_size=8, in_channels=3, cond_type="sum")
        out["jumps"] = jsum.ddpm_sample(jfn, jax.random.PRNGKey(4), 2,
                                        cond=jnp.concatenate([x0, mask], axis=-1), **JUMPS).x
        jd6 = JGD.create(timesteps=6, image_size=8, in_channels=3)
        for stateful in (False, True):
            lib_fn = cached_denoiser if stateful else closed_form_denoiser
            out[f"cfg_{stateful}"] = jd6.ddpm_sample(lib_fn(jnp), jax.random.PRNGKey(6), 2,
                                                     **as_j(_label_cfg_kw(stateful))).x
        return out

    return {k: np.asarray(v) for k, v in run(*map(jnp.asarray, (x_T, x0, mask))).items()}


@pytest.mark.parametrize("inpaint", [False, True])
def test_ddim_eta0_trajectory(models, jax_refs, inpaint):
    _, tfn = models
    x_T = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    x0, mask = _x0_and_mask() if inpaint else (None, None)
    key = jax.random.PRNGKey(2)
    ref = jax_refs[f"ddim_{inpaint}"]
    # replay the JAX sampler's per-step mask-composite draws
    k = jax.random.split(key)[1]
    draws = []
    for _ in range(10):
        k, _nk, mk = jax.random.split(k, 3)
        draws.append(torch.from_numpy(np.array(jax.random.normal(mk, SHAPE, jnp.float32))))
    td = TGD.create(timesteps=50, image_size=8, in_channels=3)
    out = td.ddim_sample(tfn, 2, device="cpu", num_steps=10, x_T=torch.from_numpy(x_T),
                         mask=None if mask is None else torch.from_numpy(mask),
                         x0=None if x0 is None else torch.from_numpy(x0),
                         noise_fn=lambda i, role: draws[i]).x
    assert out.dtype == torch.float32
    assert rel_err(out, ref) <= TRAJ_TOL


def _jax_ddpm_draws(key, n_ops):
    """x_T and per-op noises exactly as JGD.ddpm_sample draws them."""
    init_rng, k = jax.random.split(key)
    x_T = np.array(jax.random.normal(init_rng, SHAPE, jnp.float32))
    draws = []
    for _ in range(n_ops):
        k, nk = jax.random.split(k)
        draws.append(np.array(jax.random.normal(nk, SHAPE, jnp.float32)))
    return x_T, draws


def test_ddpm_repaint_steps_match_reverse_step(models):
    """Port ddpm_sample (RePaint-sum, injected noise) against JAX's
    _reverse_step plus the known-region composite, step by step."""
    jfn, tfn = models
    T = 6
    gt, known = _x0_and_mask()
    x_T, draws = _jax_ddpm_draws(jax.random.PRNGKey(3), T)
    jd = JGD.create(timesteps=T, image_size=8, in_channels=3, cond_type="sum")
    x = jnp.asarray(x_T)
    for i, t_scalar in enumerate(range(T - 1, -1, -1)):
        t = jnp.full((2,), t_scalar, jnp.int32)
        noise = jnp.asarray(draws[i])
        x = known * jd.q_sample(jnp.asarray(gt), t, noise) + (1.0 - known) * x
        x, _ = jd._reverse_step(jfn, x, t, noise, None, None, clip=True)
    td = TGD.create(timesteps=T, image_size=8, in_channels=3, cond_type="sum")
    cond = torch.from_numpy(np.concatenate([gt, known], axis=-1))
    out = td.ddpm_sample(tfn, 2, device="cpu", cond=cond, x_T=torch.from_numpy(x_T),
                         noise_fn=lambda i, role: torch.from_numpy(draws[i])).x
    assert rel_err(out, x) <= TRAJ_TOL


def test_ddpm_repaint_jumps_match_jax_sampler(models, jax_refs):
    _, tfn = models
    T, jump_len, jump_n = 6, JUMPS["jump_len"], JUMPS["jump_n"]
    gt, known = _x0_and_mask()
    cond = np.concatenate([gt, known], axis=-1)
    key = jax.random.PRNGKey(4)
    ref = jax_refs["jumps"]
    t_ops, _ = repaint_op_sequence(T, jump_len, jump_n)
    n_ops = len(t_ops)
    assert n_ops > T  # the jumps add forward ops
    x_T, draws = _jax_ddpm_draws(key, n_ops)
    td = TGD.create(timesteps=T, image_size=8, in_channels=3, cond_type="sum")
    out = td.ddpm_sample(tfn, 2, device="cpu", cond=torch.from_numpy(cond),
                         x_T=torch.from_numpy(x_T), jump_len=jump_len, jump_n=jump_n,
                         noise_fn=lambda i, role: torch.from_numpy(draws[i])).x
    assert rel_err(out, ref) <= TRAJ_TOL


@pytest.mark.parametrize("stateful", [False, True])
def test_ddpm_label_cfg_threshold_matches_jax(jax_refs, stateful):
    """Ancestral DDPM with label-CFG (the rescale, and the interval, whose
    edges 0.2 and 0.8 are levels t / (T - 1) of this chain) and dynamic
    thresholding on the closed-form denoiser of torch_parity, stateful or
    not, the JAX sampler's draws replayed."""
    T = 6
    key = jax.random.PRNGKey(6)
    x_T, draws = _jax_ddpm_draws(key, T)
    kw = _label_cfg_kw(stateful)
    lib_fn = cached_denoiser if stateful else closed_form_denoiser
    ref = jax_refs[f"cfg_{stateful}"]
    td = TGD.create(timesteps=T, image_size=8, in_channels=3)
    out = td.ddpm_sample(lib_fn(torch), 2, device="cpu", x_T=torch.from_numpy(x_T),
                         noise_fn=lambda i, role: torch.from_numpy(draws[i]), **{
                             k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()}).x
    assert out.dtype == torch.float32 and rel_err(out, ref) <= TRAJ_TOL


def test_unported_sampler_options_raise(models):
    """These options work now: an identity ``x0_proj`` leaves DDIM as it
    was, ``log_every`` returns the frames, ``self_condition`` is the
    process's field (their parity is in test_torch_sampler_extras.py)."""
    _, tfn = models
    td = TGD.create(timesteps=4, image_size=8, in_channels=3)
    x_T = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 8, 8, 3)).astype(np.float32))
    plain = td.ddim_sample(tfn, 1, device="cpu", num_steps=2, x_T=x_T).x
    proj = td.ddim_sample(tfn, 1, device="cpu", num_steps=2, x_T=x_T, x0_proj=lambda x: x).x
    assert torch.equal(plain, proj)
    out = td.ddpm_sample(tfn, 1, device="cpu", log_every=1, x_T=x_T)
    assert out.intermediates.shape == (4, 1, 8, 8, 3) and torch.equal(out.intermediates[-1], out.x)
    assert TGD.create(timesteps=4, self_condition=True).self_condition
