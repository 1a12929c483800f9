"""The port's LatentDiffusion (eo_diffusion_torch.diffusion.latent) against the
JAX package's, f32 on the CPU, over a tiny first stage with randomised
weights: the latent rectified-flow loss of a tiny concat-conditioned DiT
(the cloudy view encoded by the first stage) and the latent DDPM loss of a
tiny UNet, with the JAX draws of t and the latent noise injected; a latent
flow Heun trajectory and a DDIM eta-0 trajectory from a shared x_T, decoded
to pixels. One jitted JAX function returns all four."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion.flow import FlowMatching as TFM
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_torch.diffusion.latent import LatentDiffusion as TLD
from eo_diffusion_torch.models import autoencoder as TA
from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.weights import ae_state_dict_from_jax_params, dit_state_dict_from_jax_params
from eo_diffusion_tpu.diffusion.flow import FlowMatching as JFM
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from eo_diffusion_tpu.diffusion.latent import LatentDiffusion as JLD
from eo_diffusion_tpu.models import autoencoder as JA
from eo_diffusion_tpu.models import dit as JD
from torch_parity import (configs, fill_params, one_torch_thread, port_model,  # noqa: F401
                          random_dit_params, random_params, rel_err)

# the losses: |torch - jax| / |jax|; the decoded trajectories: max |torch -
# jax| / max |jax|
LOSS_TOL = 1e-5
TRAJ_TOL = 5e-5
SIZE, LAT, ZC, N, T, SCALE = 16, 8, 4, 2, 50, 0.7
AE = dict(in_channels=3, latent_channels=ZC, base_channels=8, num_down=1)
DIT = dict(image_size=LAT, in_channels=2 * ZC, out_channels=ZC, patch_size=2, hidden_size=32,
           depth=1, num_heads=2)
UNET = dict(image_size=LAT, in_channels=ZC, model_channels=16, out_channels=ZC,
            num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2), num_heads=1)
FLOW_STEPS, DDIM_STEPS = 4, 5


@pytest.fixture(scope="module")
def twin():
    jae = JA.ConvAutoencoder(JA.AutoencoderConfig(**AE))
    ae_params = fill_params(jax.eval_shape(jae.init, jax.random.PRNGKey(0),
                                           jnp.zeros((1, SIZE, SIZE, 3))), seed=31)
    jdit, dit_params = random_dit_params(JD.DiTConfig(**DIT), seed=32, cond_channels=ZC)
    jucfg, tucfg = configs(**UNET)
    junet, unet_params = random_params(jucfg, seed=33)
    rng = np.random.default_rng(3)
    d = dict(x0=rng.uniform(-1, 1, size=(N, SIZE, SIZE, 3)),
             cond=rng.uniform(-1, 1, size=(N, SIZE, SIZE, 3)),
             noise=rng.normal(size=(N, LAT, LAT, ZC)), x_T=rng.normal(size=(N, LAT, LAT, ZC)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    key = jax.random.PRNGKey(4)

    @jax.jit
    def run(ae_params, dit_params, unet_params, x0, cond, noise, x_T):
        enc = lambda x: jae.apply(ae_params, x, method="encode")
        dec = lambda z: jae.apply(ae_params, z, method="decode")
        flow = JLD(JFM.create(image_size=LAT, in_channels=ZC, cond_type="concat"), enc, dec,
                   scale_factor=SCALE, cond_via_encoder=True)
        ddpm = JLD(JGD.create(timesteps=T, image_size=LAT, in_channels=ZC), enc, dec,
                   scale_factor=SCALE)
        dit_fn = lambda x, t, c, y: jdit.apply(dit_params, x, t, cond=c, y=y)
        unet_fn = lambda x, t, c, y: junet.apply(unet_params, x, t, cond=c, y=y)
        return (flow.train_loss(dit_fn, key, x0, cond=cond, noise=noise),
                ddpm.train_loss(unet_fn, key, x0, noise=noise),
                flow.sample(dit_fn, key, N, num_steps=FLOW_STEPS, method="heun", cond=cond,
                            x_T=x_T).x,
                ddpm.ddim_sample(unet_fn, key, N, num_steps=DDIM_STEPS, x_T=x_T).x)

    ref = [np.asarray(a) for a in run(ae_params, dit_params, unet_params,
                                      **{k: jnp.asarray(v) for k, v in d.items()})]
    # the draws of t inside the JAX losses (flow/gaussian train_loss)
    t_flow = np.array(jax.random.uniform(jax.random.split(key)[0], (N,), jnp.float32))
    t_ddpm = np.array(jax.random.randint(jax.random.split(key, 3)[0], (N,), 0, T))

    tae = TA.ConvAutoencoder(TA.AutoencoderConfig(**AE))
    tae.load_state_dict(ae_state_dict_from_jax_params(ae_params, tae.config), strict=True)
    tdit = TD.DiT(TD.DiTConfig(**DIT))
    tdit.load_state_dict(dit_state_dict_from_jax_params(dit_params, tdit.config), strict=True)
    models = dict(ae=tae.eval(), dit=tdit.eval(), unet=port_model(tucfg, unet_params))
    inputs = {k: torch.from_numpy(v) for k, v in d.items()}
    return models, inputs, dict(t_flow=torch.from_numpy(t_flow),
                                t_ddpm=torch.from_numpy(t_ddpm)), ref


def _latent(models, inner, **kw):
    return TLD(inner, models["ae"].encode, models["ae"].decode, scale_factor=SCALE, **kw)


def test_latent_losses_match_jax(twin):
    models, d, t, (flow_loss, ddpm_loss, *_) = twin
    flow = _latent(models, TFM.create(image_size=LAT, in_channels=ZC, cond_type="concat"),
                   cond_via_encoder=True)
    seen = []

    def dit_fn(x, tt, c, y):
        seen.append((tuple(x.shape), tuple(c.shape)))
        return models["dit"](x, tt, cond=c, y=y)

    got = flow.train_loss(dit_fn, d["x0"], cond=d["cond"], noise=d["noise"], t=t["t_flow"])
    assert seen == [((N, LAT, LAT, ZC), (N, LAT, LAT, ZC))]  # x and cond both encoded
    assert abs(float(got.detach()) - float(flow_loss)) / abs(float(flow_loss)) <= LOSS_TOL
    ddpm = _latent(models, TGD.create(timesteps=T, image_size=LAT, in_channels=ZC))
    unet = models["unet"]
    got = ddpm.train_loss(lambda x, tt, c, y: unet(x, tt, cond=c, y=y), d["x0"],
                          noise=d["noise"], t=t["t_ddpm"])
    assert abs(float(got.detach()) - float(ddpm_loss)) / abs(float(ddpm_loss)) <= LOSS_TOL


def test_frozen_first_stage_keeps_no_graph(twin):
    """The loss's gradient reaches the denoiser and nothing of the first
    stage: encode runs under no_grad, so the encoded latents carry no graph
    even when the autoencoder's parameters would take gradients."""
    models, d, t, _ = twin
    ae = models["ae"].requires_grad_(True)
    flow = _latent(models, TFM.create(image_size=LAT, in_channels=ZC, cond_type="concat"),
                   cond_via_encoder=True)
    z = flow.encode(d["x0"])
    assert not z.requires_grad and z.grad_fn is None
    dit = models["dit"]
    loss = flow.train_loss(lambda x, tt, c, y: dit(x, tt, cond=c, y=y), d["x0"],
                           cond=d["cond"], noise=d["noise"], t=t["t_flow"])
    loss.backward()
    assert all(p.grad is None for p in ae.parameters())
    assert all(p.grad is not None for p in dit.parameters())
    dit.zero_grad(set_to_none=True)
    ae.requires_grad_(False)


@torch.no_grad()
def test_latent_trajectories_match_jax(twin):
    models, d, _, (*_, heun, ddim) = twin
    dit, unet = models["dit"], models["unet"]
    flow = _latent(models, TFM.create(image_size=LAT, in_channels=ZC, cond_type="concat"),
                   cond_via_encoder=True)
    got = flow.sample(lambda x, tt, c, y: dit(x, tt, cond=c, y=y), N, device="cpu",
                      num_steps=FLOW_STEPS, method="heun", cond=d["cond"], x_T=d["x_T"]).x
    assert got.shape == (N, SIZE, SIZE, 3) and got.dtype == torch.float32
    assert rel_err(got, heun) <= TRAJ_TOL
    ddpm = _latent(models, TGD.create(timesteps=T, image_size=LAT, in_channels=ZC))
    got = ddpm.ddim_sample(lambda x, tt, c, y: unet(x, tt, cond=c, y=y), N, device="cpu",
                           num_steps=DDIM_STEPS, x_T=d["x_T"]).x
    assert got.shape == (N, SIZE, SIZE, 3) and rel_err(got, ddim) <= TRAJ_TOL


def test_surface_and_refusals(twin):
    models, d, _, _ = twin
    inner = TGD.create(timesteps=T, image_size=LAT, in_channels=ZC)
    ld = _latent(models, inner)
    assert (ld.image_size, ld.in_channels, ld.cond_type) == (LAT, ZC, None)
    zeros = lambda x, tt, c, y: torch.zeros_like(x)
    g = torch.Generator().manual_seed(0)
    out = ld.ddpm_sample(zeros, N, device="cpu", generator=g)
    assert out.x.shape == (N, SIZE, SIZE, 3)
    # encode_cond routes a concat cond through the first stage per call
    seen = []
    spy = lambda x, tt, c, y: seen.append(tuple(c.shape)) or torch.zeros_like(x)
    ld.ddim_sample(spy, N, device="cpu", generator=g, num_steps=2, cond=d["cond"],
                   encode_cond=True)
    assert seen[0] == (N, LAT, LAT, ZC)
    # DPM-Solver++ and UniPC run on the latent grid and decode; a CFG uncond
    # image rides the first stage like cond
    seen.clear()
    for name in ("dpm_sample", "unipc_sample"):
        out = getattr(ld, name)(spy, N, device="cpu", generator=g, num_steps=2, cond=d["cond"],
                                uncond=torch.zeros_like(d["cond"]), guidance_scale=2.0,
                                encode_cond=True)
        assert out.x.shape == (N, SIZE, SIZE, 3) and torch.isfinite(out.x).all()
    assert seen == [(2 * N, LAT, LAT, ZC)] * 5  # two DPM calls, three UniPC
