"""Self-conditioning, ``log_every`` frames and interpolation of the port
against eo_diffusion_tpu's (f32, CPU, closed-form denoisers): the
self-conditioned loss with the JAX coin injected, self-conditioned DDPM and
DDIM trajectories with their frames, the frames of the flow, EDM and bridge
samplers, and ``GaussianDiffusion.interpolate`` with the JAX draws
injected. One jitted JAX function computes every reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.core.schedules import make_ddim_schedule
from eo_diffusion_torch.diffusion import tiled as TT
from eo_diffusion_torch.diffusion.bridge import BrownianBridge as TB
from eo_diffusion_torch.diffusion.edm import EDMProcess as TE
from eo_diffusion_torch.diffusion.flow import FlowMatching as TF
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_tpu.diffusion.bridge import BrownianBridge as JB
from eo_diffusion_tpu.diffusion.edm import EDMProcess as JE
from eo_diffusion_tpu.diffusion.flow import FlowMatching as JF
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from torch_parity import closed_form_denoiser, one_torch_thread, rel_err  # noqa: F401

LOSS_TOL = 1e-5  # f32 loss: |port - jax| / |jax|
TRAJ_TOL = 5e-5  # trajectories and frames: max |port - jax| / max |jax|
T, N, SHAPE = 20, 2, (2, 8, 8, 3)
DDIM_STEPS, INTERP_T, EVERY = 6, 7, 3
LOSS_KEYS = (0, 3)  # PRNG seeds whose self-conditioning coins differ (asserted below)


def _normal(key, shape=SHAPE):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def _ddpm_draws(key, n_ops):
    init_rng, k = jax.random.split(key)
    draws = []
    for _ in range(n_ops):
        k, nk = jax.random.split(k)
        draws.append(_normal(nk))
    return _normal(init_rng), draws


def _ddim_draws(key, steps):
    init_rng, k = jax.random.split(key)
    draws = []
    for _ in range(steps):
        k, nk, _mk = jax.random.split(k, 3)
        draws.append(_normal(nk))
    return _normal(init_rng), draws


def _interp_draws(key, t):
    r1, r2, k = jax.random.split(key, 3)
    draws = []
    for _ in range(t):
        k, nk = jax.random.split(k)
        draws.append(_normal(nk))
    return _normal(r1), _normal(r2), draws


def _loss_draws(key):
    """t, noise and the self-conditioning coin of JGD.train_loss's key."""
    t_rng, _n_rng, sc_rng = jax.random.split(key, 3)
    return (np.array(jax.random.randint(t_rng, (N,), 0, T)),
            bool(jax.random.bernoulli(sc_rng, 0.5)))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(12)
    ins = dict(x0=rng.uniform(-1, 1, size=SHAPE).astype(np.float32),
               x2=rng.uniform(-1, 1, size=SHAPE).astype(np.float32),
               noise=rng.normal(size=SHAPE).astype(np.float32),
               x_T=rng.normal(size=SHAPE).astype(np.float32))
    keys = {name: jax.random.PRNGKey(i) for i, name in enumerate(("ddpm", "ddim", "interp"))}
    jd = JGD.create(timesteps=T, image_size=8, in_channels=3, self_condition=True)
    jplain = JGD.create(timesteps=T, image_size=8, in_channels=3)
    jf, je, jb = JF.create(image_size=8, in_channels=3), JE.create(8), JB.create(8, timesteps=T)
    f = closed_form_denoiser(jnp)

    @jax.jit
    def run(x0, x2, noise, x_T):
        out = {f"loss{k}": jd.train_loss(f, jax.random.PRNGKey(k), x0, noise=noise)
               for k in LOSS_KEYS}
        for name, o in (
                ("ddpm", jd.ddpm_sample(f, keys["ddpm"], N, log_every=EVERY)),
                ("ddim", jd.ddim_sample(f, keys["ddim"], N, num_steps=DDIM_STEPS, eta=0.5,
                                        clip=True, log_every=EVERY)),
                ("flow", jf.sample(f, keys["ddpm"], N, num_steps=5, x_T=x_T, log_every=2)),
                ("edm", je.sample(f, keys["ddpm"], N, num_steps=4, x_T=x_T, log_every=2)),
                ("bridge", jb.sample(f, keys["ddpm"], N, num_steps=5, cond=x0, eta=0.0,
                                     log_every=2))):
            out[name], out[f"{name}_frames"] = o.x, o.intermediates
        out["interp"] = jplain.interpolate(f, keys["interp"], x0, x2, lam=0.3, t=INTERP_T).x
        return out

    refs = {k: np.asarray(v) for k, v in run(*(jnp.asarray(ins[k]) for k in (
        "x0", "x2", "noise", "x_T"))).items()}
    return {k: torch.from_numpy(v) for k, v in ins.items()}, keys, refs


def test_self_conditioned_loss_matches_jax(case):
    ins, _, refs = case
    td = TGD.create(timesteps=T, image_size=8, in_channels=3, self_condition=True)
    coins = []
    for k in LOSS_KEYS:
        t, coin = _loss_draws(jax.random.PRNGKey(k))
        coins.append(coin)
        loss = td.train_loss(closed_form_denoiser(torch), ins["x0"], noise=ins["noise"],
                             t=torch.from_numpy(t), self_cond_coin=coin)
        assert abs(loss.item() - refs[f"loss{k}"]) <= LOSS_TOL * abs(refs[f"loss{k}"])
    assert sorted(coins) == [False, True]  # both branches of the 50 % coin


def test_self_conditioned_ddpm_trajectory_and_frames(case):
    _, keys, refs = case
    x_T, draws = _ddpm_draws(keys["ddpm"], T)
    td = TGD.create(timesteps=T, image_size=8, in_channels=3, self_condition=True)
    out = td.ddpm_sample(closed_form_denoiser(torch), N, device="cpu",
                         x_T=torch.from_numpy(x_T), log_every=EVERY,
                         noise_fn=lambda i, role: torch.from_numpy(draws[i]))
    assert rel_err(out.x, refs["ddpm"]) <= TRAJ_TOL
    assert out.intermediates.shape == (-(-T // EVERY),) + SHAPE
    assert rel_err(out.intermediates, refs["ddpm_frames"]) <= TRAJ_TOL


def test_self_conditioned_ddim_trajectory_and_frames(case):
    _, keys, refs = case
    td = TGD.create(timesteps=T, image_size=8, in_channels=3, self_condition=True)
    steps = make_ddim_schedule(td.schedule, DDIM_STEPS, 0.5).num_steps  # the guard adds one
    x_T, draws = _ddim_draws(keys["ddim"], steps)
    out = td.ddim_sample(closed_form_denoiser(torch), N, device="cpu", num_steps=DDIM_STEPS,
                         eta=0.5, clip=True, x_T=torch.from_numpy(x_T), log_every=EVERY,
                         noise_fn=lambda i, role: torch.from_numpy(draws[i]))
    assert rel_err(out.x, refs["ddim"]) <= TRAJ_TOL
    assert out.intermediates.shape == (-(-steps // EVERY),) + SHAPE
    assert rel_err(out.intermediates, refs["ddim_frames"]) <= TRAJ_TOL


@pytest.mark.parametrize("name", ["flow", "edm", "bridge"])
def test_frames_of_the_other_samplers(case, name):
    ins, _, refs = case
    f = closed_form_denoiser(torch)
    if name == "flow":
        out = TF.create(image_size=8, in_channels=3).sample(f, N, device="cpu", num_steps=5,
                                                            x_T=ins["x_T"], log_every=2)
    elif name == "edm":
        out = TE.create(8).sample(f, N, device="cpu", num_steps=4, x_T=ins["x_T"], log_every=2)
    else:
        out = TB.create(8, timesteps=T).sample(f, N, device="cpu", num_steps=5, cond=ins["x0"],
                                               eta=0.0, log_every=2)
    frames = refs[f"{name}_frames"]
    assert out.intermediates.shape == frames.shape and frames.shape[0] in (2, 3)
    assert rel_err(out.intermediates, frames) <= TRAJ_TOL
    assert rel_err(out.x, refs[name]) <= TRAJ_TOL


def test_interpolate_matches_jax(case):
    ins, keys, refs = case
    e1, e2, draws = _interp_draws(keys["interp"], INTERP_T)
    first = {"x1": e1, "x2": e2}
    td = TGD.create(timesteps=T, image_size=8, in_channels=3)
    out = td.interpolate(closed_form_denoiser(torch), ins["x0"], ins["x2"], lam=0.3, t=INTERP_T,
                         noise_fn=lambda i, role: torch.from_numpy(
                             first[role] if role in first else draws[i]))
    assert out.x.shape == SHAPE and rel_err(out.x, refs["interp"]) <= TRAJ_TOL


def test_self_condition_refusals():
    td = TGD.create(timesteps=T, image_size=8, in_channels=3, self_condition=True)
    with pytest.raises(AssertionError, match="two-pass train_loss"):
        td.training_tuple(torch.zeros(SHAPE))
    with pytest.raises(AssertionError, match="self_condition"):
        TT.tiled_ddim_sample(td, closed_form_denoiser(torch), 1, 16, 16, device="cpu")
