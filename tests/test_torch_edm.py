"""The port's EDM process (eo_diffusion_torch.diffusion.edm) against the JAX
package's ``EDMProcess``, f32 on the CPU: the Karras grid and the
preconditioning coefficients to an ulp or two, the loss of the tiny-dit-edm
DiT at the JAX draw of sigma with the noise injected, Heun through the
tiny-edm UNet and Euler through the DiT from a shared x_T (one jitted JAX
function returns them all), then trajectories on a closed-form
denoiser with the inpainting and churn draws of the JAX sampler injected,
and with image-CFG (rescale, interval) and a stateful denoiser. The mask
path keeps the known region at x0 exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.cli import presets as TP
from eo_diffusion_torch.diffusion import edm as TE
from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params
from eo_diffusion_tpu.diffusion import edm as JE
from eo_diffusion_tpu.models import dit as JD
from torch_parity import (cached_denoiser, closed_form_denoiser, configs,  # noqa: F401
                          one_torch_thread, port_model, random_dit_params, random_params, rel_err)

LOSS_TOL = 1e-5   # |torch - jax| / |jax|
TRAJ_TOL = 5e-5   # max |torch - jax| / max |jax| over the final samples
N = 2


def _ulps(a, b):
    """The largest distance in float32 units in the last place."""
    a, b = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (a, b))
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("steps,rho", [(1, 7.0), (18, 7.0), (35, 7.0), (100, 3.0)])
def test_karras_sigmas_match_jnp_to_an_ulp(steps, rho):
    got = TE.karras_sigmas(steps, 0.002, 80.0, rho)
    ref = np.asarray(JE.karras_sigmas(steps, 0.002, 80.0, rho))
    assert got.dtype == np.float32 and got.shape == (steps + 1,) and got[-1] == 0.0
    assert _ulps(got, ref) <= 1


def test_preconditioning_matches_jax_to_an_ulp():
    """c_skip and c_in within an ulp of JAX's over the Karras grid and the
    training range. c_out and the model's t within two: each is a product
    on a value (the rsqrt, the log) that XLA's CPU code computes an ulp from
    the correctly rounded one the port takes. t_model is negative below
    sigma 1 and stays a float."""
    sig = np.concatenate([TE.karras_sigmas(18, 0.002, 80.0, 7.0)[:-1],
                          np.exp(np.linspace(-5, 3, 2000))]).astype(np.float32)
    got = TE.EDMProcess.create(8)._coeffs(torch.from_numpy(sig))
    ref = JE.EDMProcess.create(8)._coeffs(jnp.asarray(sig))
    for name, g, r, ulps in zip(("c_skip", "c_in", "c_out", "t_model"), got, ref, (1, 1, 2, 2)):
        assert g.dtype == torch.float32 and _ulps(g.numpy(), r) <= ulps, name
    assert got[3][0] > 0 > got[3][17] and float(got[3][17]) < -300  # sigma_max, sigma_min


@pytest.fixture(scope="module")
def twin():
    """The tiny-edm UNet and the tiny-dit-edm DiT in both packages from the
    same seeded weights, and what one jitted JAX function gives: the DiT's
    loss at the key's sigma with injected noise, Heun-4 through the UNet and
    Euler-3 through the DiT from a shared x_T."""
    up, dp = TP.get_preset("tiny-edm"), TP.get_preset("tiny-dit-edm")
    ucfg = TP.get_preset("tiny-edm").unet_config(bf16=False)
    jucfg, tucfg = configs(**{f: getattr(ucfg, f) for f in (
        "image_size", "in_channels", "model_channels", "out_channels", "num_res_blocks",
        "attention_resolutions", "channel_mult", "num_heads")})
    junet, uparams = random_params(jucfg, seed=41)
    dcfg = dp.model_config(bf16=False)
    dkw = {f: getattr(dcfg, f) for f in ("image_size", "in_channels", "out_channels",
                                         "patch_size", "hidden_size", "depth", "num_heads")}
    jdit, dparams = random_dit_params(JD.DiTConfig(**dkw), seed=42)
    rng = np.random.default_rng(5)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    d = {"u_xT": 80.0 * f32(N, 8, 8, 3),
         "d_x0": rng.uniform(-1, 1, (N, 16, 16, 3)).astype(np.float32),
         "d_noise": f32(N, 16, 16, 3), "d_xT": 80.0 * f32(N, 16, 16, 3)}
    key = jax.random.PRNGKey(9)
    ju, jd = (JE.EDMProcess.create(image_size=p.image_size) for p in (up, dp))

    @jax.jit
    def run(uparams, dparams, u_xT, d_x0, d_noise, d_xT):
        ufn = lambda x, t, c, y: junet.apply(uparams, x, t, cond=c, y=y)
        dfn = lambda x, t, c, y: jdit.apply(dparams, x, t, cond=c, y=y)
        return (jd.train_loss(dfn, key, d_x0, noise=d_noise),
                ju.sample(ufn, key, N, num_steps=4, method="heun", x_T=u_xT).x,
                jd.sample(dfn, key, N, num_steps=3, method="euler", x_T=d_xT).x)

    ref = [np.asarray(a) for a in run(uparams, dparams,
                                      **{k: jnp.asarray(v) for k, v in d.items()})]
    # the sigma the JAX loss draws (edm.py:113-117)
    sigma = np.asarray(jnp.exp(-1.2 + 1.2 * jax.random.normal(jax.random.split(key)[0], (N,))))
    tdit = TD.DiT(TD.DiTConfig(**dkw))
    tdit.load_state_dict(dit_state_dict_from_jax_params(dparams, tdit.config), strict=True)
    return {"unet": port_model(tucfg, uparams), "dit": tdit.eval(), "data": d, "ref": ref,
            "sigma": sigma}


def _fn(model):
    return lambda x, t, c, y: model(x, t, cond=c, y=y)


def test_loss_at_the_jax_sigma_matches(twin):
    d = twin["data"]
    with torch.no_grad():
        loss = TE.EDMProcess.create(16).train_loss(
            _fn(twin["dit"]), torch.from_numpy(d["d_x0"]), noise=torch.from_numpy(d["d_noise"]),
            t=torch.from_numpy(twin["sigma"].copy()))
    ref = float(twin["ref"][0])
    assert abs(float(loss) - ref) / abs(ref) <= LOSS_TOL


@pytest.mark.parametrize("case", ["unet-heun4", "dit-euler3"])
def test_trajectory_from_a_shared_x_T_matches(twin, case):
    """Heun (two calls a step, the last step Euler: 7 calls for 4 steps)
    and Euler from the same x_T, s_churn 0, through the two backbones."""
    which, method = case.split("-")
    steps = int(method[-1])
    pre, size = ("u", 8) if which == "unet" else ("d", 16)
    calls = []
    model = _fn(twin[which])

    def counted(x, t, c, y):
        calls.append(float(t[0]))
        return model(x, t, c, y)

    with torch.no_grad():
        out = TE.EDMProcess.create(size).sample(
            counted, N, device="cpu", num_steps=steps, method=method[:-1],
            x_T=torch.from_numpy(twin["data"][f"{pre}_xT"])).x
    ref = twin["ref"][{"unet-heun4": 1, "dit-euler3": 2}[case]]
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel_err(out, ref) <= TRAJ_TOL
    assert len(calls) == (2 * steps - 1 if method.startswith("heun") else steps)
    assert calls[0] == pytest.approx(np.log(80.0) / 4 * 250, rel=1e-6) and calls[-1] < -300


def _jax_draws(key, steps, shape):
    """The JAX sampler's per-step draws: ``fold_in(churn_rng, i)`` and
    ``fold_in(mask_rng, i)`` after ``split(rng, 3)`` (edm.py:178, :214, :225)."""
    _, churn_rng, mask_rng = jax.random.split(key, 3)
    draw = lambda r, i: torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(r, i), shape, jnp.float32)))
    return {"churn": [draw(churn_rng, i) for i in range(steps)],
            "mask": [draw(mask_rng, i) for i in range(steps)]}


CASES = {  # method, steps, mask, churn, guidance, stateful
    "heun_churn_mask": ("heun", 5, True, 30.0, False, False),
    "euler_image_cfg_rescale_interval_state": ("euler", 6, False, 0.0, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_closed_form_trajectory_matches_jax(case):
    """Inpainting (the known region re-noised to the current sigma with the
    JAX draws, pasted at the end), churn (the JAX churn draws) and image-CFG
    with the rescale, the interval at sigma / sigma_max and a stateful
    denoiser, on a closed-form denoiser in both frameworks."""
    method, steps, inpaint, churn, guide, stateful = CASES[case]
    rng = np.random.default_rng(len(case))
    shape = (N, 8, 8, 3)
    x_T = (80.0 * rng.normal(size=shape)).astype(np.float32)
    kw = dict(num_steps=steps, method=method, s_churn=churn, s_tmin=0.5, s_tmax=30.0)
    np_kw = {}
    if inpaint:
        np_kw["mask"] = (rng.uniform(size=(N, 8, 8, 1)) > 0.5).astype(np.float32)
        np_kw["x0"] = rng.uniform(-1, 1, size=shape).astype(np.float32)
    if guide:
        kw.update(guidance_scale=3.0, guidance_rescale=0.7, guidance_interval=(0.002, 0.3))
        np_kw["cond"] = rng.uniform(-1, 1, size=shape).astype(np.float32)
        np_kw["uncond"] = np.zeros(shape, np.float32)
    if stateful:
        np_kw["model_state"] = np.zeros((2 * N,) + shape[1:], np.float32)
    fns = {lib: (cached_denoiser(lib) if stateful else closed_form_denoiser(lib))
           for lib in (jnp, torch)}
    key = jax.random.PRNGKey(11)
    ref = JE.EDMProcess.create(8).sample(fns[jnp], key, N, x_T=jnp.asarray(x_T), **kw,
                                         **{k: jnp.asarray(v) for k, v in np_kw.items()}).x
    draws = _jax_draws(key, steps, shape)
    out = TE.EDMProcess.create(8).sample(
        fns[torch], N, device="cpu", x_T=torch.from_numpy(x_T),
        noise_fn=lambda i, role: draws[role][i], **kw,
        **{k: torch.from_numpy(v) for k, v in np_kw.items()}).x
    assert out.dtype == torch.float32 and out.shape == shape
    assert rel_err(out, ref) <= TRAJ_TOL
    if inpaint:  # the known pixels are x0's, to the bit
        known = np.broadcast_to(np_kw["mask"], shape) > 0
        np.testing.assert_array_equal(out.numpy()[known], np_kw["x0"][known])


def test_sampler_refusals():
    proc = TE.EDMProcess.create(8)
    fn = closed_form_denoiser(torch)
    with pytest.raises(ValueError, match="euler"):
        proc.sample(fn, 1, device="cpu", num_steps=2, method="rk4")
    with pytest.raises(AssertionError, match="x0"):
        proc.sample(fn, 1, device="cpu", num_steps=2, mask=torch.ones(1, 8, 8, 1))
    # log_every frames: one a step, the last the result
    out = proc.sample(fn, 1, device="cpu", num_steps=2, log_every=1)
    assert out.intermediates.shape == (2, 1, 8, 8, 3)
    assert torch.equal(out.intermediates[-1], out.x)
