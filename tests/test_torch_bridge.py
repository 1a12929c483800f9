"""The port's Brownian bridge (eo_diffusion_torch.diffusion.bridge) against the
JAX package's ``BrownianBridge``, f32 on the CPU: the strided grid's tables
to the last bit, the posterior step at both endpoints exactly, the tiny-bridge
UNet's loss at the JAX draw of t with the noise injected, the eta-0 walk
through that UNet, ``tiled_bridge_sample`` of a scene several tiles wide and
the latent bridge behind the tiny-latent-bridge first stage (one jitted JAX
function returns those four), and the eta > 0 walk with the JAX posterior
draws injected, on a closed-form denoiser."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.cli import presets as TP
from eo_diffusion_torch.diffusion import bridge as TB
from eo_diffusion_torch.diffusion import tiled as TT
from eo_diffusion_torch.diffusion.latent import LatentDiffusion as TLD
from eo_diffusion_torch.models import autoencoder as TA
from eo_diffusion_torch.weights import ae_state_dict_from_jax_params
from eo_diffusion_tpu.diffusion import bridge as JB
from eo_diffusion_tpu.diffusion import tiled as JT
from eo_diffusion_tpu.diffusion.latent import LatentDiffusion as JLD
from eo_diffusion_tpu.models import autoencoder as JA
from torch_parity import (closed_form_denoiser, configs, fill_params,  # noqa: F401
                          one_torch_thread, port_model, random_params, rel_err)

LOSS_TOL = 1e-5   # |torch - jax| / |jax|
TRAJ_TOL = 5e-5   # max |torch - jax| / max |jax| over the final samples
N, T, STEPS = 2, 50, 5
H, W = 12, 20      # the tiled scene: 2 x 4 tiles of 8 at overlap 0.5
SCALE = 0.8


@pytest.mark.parametrize("timesteps,steps", [(50, 5), (50, 7), (50, 49), (50, 200),
                                             (1000, 50), (1000, 999)])
def test_strided_grid_matches_jax(timesteps, steps):
    """The clamped step count, the int32 time indices and the float32 m and
    delta tables computed from them, bit for bit."""
    got = TB.BrownianBridge.create(8, timesteps=timesteps).strided_grid(steps)
    ref = JB.BrownianBridge.create(8, timesteps=timesteps).strided_grid(steps)
    assert got[0] == ref[0] == min(steps, timesteps - 1)
    for g, r, dtype in zip(got[1:], ref[1:], (np.int32, np.float32, np.float32)):
        assert g.dtype == dtype and np.array_equal(g, np.asarray(r))
    assert got[2][0] == 1.0 and got[2][-1] == 0.0 and got[3][0] == got[3][-1] == 0.0


def test_strided_grid_refuses_no_steps():
    with pytest.raises(AssertionError):
        TB.BrownianBridge(8, 3, timesteps=3).strided_grid(0)


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_posterior_step_matches_jax_exactly(where):
    """The Kalman form at t = T-1 (delta_t 0: the prior), in between, and
    into s = 0 (delta_s 0: x0_hat): the same bits as JAX's."""
    _, _, m, d = JB.BrownianBridge.create(8, timesteps=T).strided_grid(STEPS)
    i = {"first": 0, "middle": 2, "last": STEPS - 1}[where]
    rng = np.random.default_rng(i)
    x, x0_hat, yf = (rng.normal(size=(N, 8, 8, 3)).astype(np.float32) for _ in range(3))
    mean_j, var_j = JB.BrownianBridge.posterior_step(
        jnp.asarray(x), jnp.asarray(x0_hat), jnp.asarray(yf), m[i], m[i + 1], d[i], d[i + 1])
    mean_t, var_t = TB.BrownianBridge.posterior_step(
        *(torch.from_numpy(a) for a in (x, x0_hat, yf)), m[i], m[i + 1], d[i], d[i + 1])
    assert mean_t.dtype == torch.float32
    np.testing.assert_array_equal(mean_t.numpy(), np.asarray(mean_j))
    assert np.float32(var_t) == np.float32(var_j)
    if where == "first":
        assert float(d[i]) == 0.0 and np.float32(var_t) == np.float32(d[i + 1])
    if where == "last":
        assert float(d[i + 1]) == 0.0 and var_t == 0.0
        np.testing.assert_array_equal(mean_t.numpy(), x0_hat)


@pytest.fixture(scope="module")
def twin():
    """The tiny-bridge UNet in both packages from the same seeded weights,
    the tiny-latent-bridge first stage likewise, and what one jitted JAX
    function gives: the UNet's loss at the key's t with injected noise, the
    eta-0 walk through it, the tiled walk of an H x W scene and the latent
    walk, the last two through a closed-form denoiser."""
    cfg = TP.get_preset("tiny-bridge").unet_config(bf16=False, cond_channels=3)
    jucfg, tucfg = configs(**{f: getattr(cfg, f) for f in (
        "image_size", "in_channels", "model_channels", "out_channels", "num_res_blocks",
        "attention_resolutions", "channel_mult", "num_heads")})
    junet, uparams = random_params(jucfg, seed=51, cond_channels=3)
    acfg = TP.get_preset("tiny-latent-bridge").ae_config()
    akw = {f: getattr(acfg, f) for f in ("in_channels", "latent_channels", "base_channels",
                                         "num_down")}
    jae = JA.ConvAutoencoder(JA.AutoencoderConfig(**akw))
    ae_params = fill_params(jax.eval_shape(jae.init, jax.random.PRNGKey(0),
                                           jnp.zeros((1, 16, 16, 3))), seed=52)
    rng = np.random.default_rng(6)
    u = lambda *s: rng.uniform(-1, 1, size=s).astype(np.float32)
    d = {"x0": u(N, 8, 8, 3), "y": u(N, 8, 8, 3),
         "noise": rng.normal(size=(N, 8, 8, 3)).astype(np.float32), "scene": u(1, H, W, 3),
         "lat_y": u(N, 16, 16, 3)}
    key = jax.random.PRNGKey(12)
    jb = JB.BrownianBridge.create(8, timesteps=T)
    cf = closed_form_denoiser(jnp)

    @jax.jit
    def run(uparams, ae_params, x0, y, noise, scene, lat_y):
        ufn = lambda x, t, c, yy: junet.apply(uparams, x, t, cond=c, y=yy)
        lat = JLD(JB.BrownianBridge.create(8, in_channels=4, timesteps=T),
                  lambda x: jae.apply(ae_params, x, method="encode"),
                  lambda z: jae.apply(ae_params, z, method="decode"), scale_factor=SCALE,
                  cond_via_encoder=True)
        return (jb.train_loss(ufn, key, x0, cond=y, noise=noise),
                jb.sample(ufn, key, N, num_steps=STEPS, cond=y, eta=0.0).x,
                JT.tiled_bridge_sample(jb, cf, key, 1, H, W, num_steps=STEPS, cond=scene,
                                       tile_batch=3).x,
                lat.sample(cf, key, N, num_steps=4, cond=lat_y, eta=0.0).x)

    ref = [np.asarray(a) for a in run(uparams, ae_params,
                                      **{k: jnp.asarray(v) for k, v in d.items()})]
    # the t the JAX loss draws (bridge.py:111-114)
    t = np.asarray(jax.random.randint(jax.random.split(key)[0], (N,), 1, T))
    tae = TA.ConvAutoencoder(TA.AutoencoderConfig(**akw))
    tae.load_state_dict(ae_state_dict_from_jax_params(ae_params, tae.config), strict=True)
    return {"unet": port_model(tucfg, uparams), "ae": tae.eval(), "data": d, "ref": ref,
            "t": t}


def _fn(model):
    return lambda x, t, c, y: model(x, t, cond=c, y=y)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_loss_at_the_jax_t_matches(twin):
    d = twin["data"]
    seen = []
    model = _fn(twin["unet"])

    def spy(x, t, c, y):
        seen.append((t.dtype, c is not None))
        return model(x, t, c, y)

    with torch.no_grad():
        loss = TB.BrownianBridge.create(8, timesteps=T).train_loss(
            spy, _t(d["x0"]), cond=_t(d["y"]), noise=_t(d["noise"]), t=_t(twin["t"]))
    ref = float(twin["ref"][0])
    assert abs(float(loss) - ref) / abs(ref) <= LOSS_TOL
    assert seen == [(torch.long, True)]  # integer steps; the source rides as concat cond


def test_eta0_walk_through_the_unet_matches(twin):
    """x starts at the source (a copy: the source is left as it was), the
    model sees the integer steps of the strided grid, x0_hat is clipped, and
    nothing is drawn at eta 0."""
    d = twin["data"]
    y = _t(d["y"])
    ts = []
    model = _fn(twin["unet"])

    def spy(x, t, c, yy):
        ts.append(int(t[0]))
        return model(x, t, c, yy)

    with torch.no_grad():
        out = TB.BrownianBridge.create(8, timesteps=T).sample(
            spy, N, device="cpu", num_steps=STEPS, cond=y, eta=0.0,
            generator=torch.Generator().manual_seed(0)).x
    assert torch.equal(y, _t(d["y"]))
    assert ts == [49, 39, 29, 20, 10]
    assert out.dtype == torch.float32 and rel_err(out, twin["ref"][1]) <= TRAJ_TOL


def test_tiled_bridge_matches_jax(twin):
    """A 12 x 20 scene in 2 x 4 tiles of 8 (chunks of 3 tiles), the source
    carried per tile into the model, the stitched residual driving the
    whole-scene posterior."""
    with torch.no_grad():
        out = TT.tiled_bridge_sample(TB.BrownianBridge.create(8, timesteps=T),
                                     closed_form_denoiser(torch), 1, H, W, device="cpu",
                                     num_steps=STEPS, cond=_t(twin["data"]["scene"]),
                                     tile_batch=3).x
    assert out.shape == (1, H, W, 3) and rel_err(out, twin["ref"][2]) <= TRAJ_TOL


def test_latent_bridge_matches_jax(twin):
    """The endpoint is the encoded source and the model's concat cond too;
    no uncond reaches the bridge; the walk decodes to pixels."""
    tae = twin["ae"]
    lat = TLD(TB.BrownianBridge.create(8, in_channels=4, timesteps=T), tae.encode, tae.decode,
              scale_factor=SCALE, cond_via_encoder=True)
    seen = []
    cf = closed_form_denoiser(torch)

    def spy(x, t, c, y):
        seen.append(tuple(c.shape))
        return cf(x, t, c, y)

    with torch.no_grad():
        out = lat.sample(spy, N, device="cpu", num_steps=4, cond=_t(twin["data"]["lat_y"]),
                         eta=0.0).x
    assert seen == [(N, 8, 8, 4)] * 4
    assert out.shape == (N, 16, 16, 3) and rel_err(out, twin["ref"][3]) <= TRAJ_TOL


def test_eta_walk_with_the_jax_draws_matches():
    """eta 0.7 with clipping off: the posterior noise of step i is the JAX
    sampler's ``normal(split(rng, S)[i])`` (bridge.py:230), injected."""
    rng = np.random.default_rng(8)
    y = rng.uniform(-1, 1, size=(N, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    kw = dict(num_steps=STEPS, eta=0.7, clip=False)
    ref = JB.BrownianBridge.create(8, timesteps=T).sample(
        closed_form_denoiser(jnp), key, N, cond=jnp.asarray(y), **kw).x
    draws = [_t(jax.random.normal(k, (N, 8, 8, 3), jnp.float32))
             for k in jax.random.split(key, STEPS)]
    out = TB.BrownianBridge.create(8, timesteps=T).sample(
        closed_form_denoiser(torch), N, device="cpu", cond=_t(y),
        noise_fn=lambda i, role: draws[i], **kw).x
    assert rel_err(out, ref) <= TRAJ_TOL


def test_refusals():
    with pytest.raises(AssertionError, match="cond_type"):
        TB.BrownianBridge.create(8, cond_type="sum")
    bb = TB.BrownianBridge.create(8, timesteps=T)
    fn = closed_form_denoiser(torch)
    with pytest.raises(AssertionError, match="source image"):
        bb.sample(fn, 1, device="cpu", num_steps=2)
    with pytest.raises(AssertionError, match="source image"):
        bb.train_loss(fn, torch.zeros(1, 8, 8, 3))
    with pytest.raises(AssertionError, match="source scene"):
        TT.tiled_bridge_sample(bb, fn, 1, H, W, device="cpu")
    # log_every frames: one a step, the last the result
    out = bb.sample(fn, 1, device="cpu", num_steps=2, cond=torch.zeros(1, 8, 8, 3), log_every=1,
                    eta=0.0)
    assert out.intermediates.shape == (2, 1, 8, 8, 3)
    assert torch.equal(out.intermediates[-1], out.x)
