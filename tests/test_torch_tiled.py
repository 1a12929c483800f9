"""The port's tiled DDIM sampling (eo_diffusion_torch.diffusion.tiled) against
the JAX package's (f32, CPU): the tile grid, unfold/fold, and whole
trajectories of a tiny concat-conditioned UNet over a scene larger than its
tile, and both tiled samplers (DDIM and the flow ODE) with CFG and a
stateful denoiser over a closed-form one. The JAX sampler's own draws are
replayed into the port (x_T from its key split, the RePaint mask noise
through ``noise_fn``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion import tiled as TT
from eo_diffusion_torch.diffusion.flow import FlowMatching as TFM
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_tpu.diffusion import tiled as JT
from eo_diffusion_tpu.diffusion.flow import FlowMatching as JFM
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from torch_parity import (cached_denoiser, configs, one_torch_thread,  # noqa: F401
                          port_model, random_params, rel_err)

# whole-trajectory f32 sampler parity: max |port - jax| / max |jax|
TRAJ_TOL = 5e-5
# fold: f32 sums of the same weighted terms, divided by the same norm
FOLD_ATOL = 1e-6
TILE, H, W, N, STEPS = 8, 16, 12, 2, 5
UNET = dict(image_size=TILE, in_channels=6, model_channels=16, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=2)


@pytest.mark.parametrize("h,w,tile,overlap", [
    (16, 12, 8, 0.5), (512, 512, 256, 0.5), (500, 300, 256, 0.25), (64, 64, 64, 0.5),
    (37, 41, 8, 0.9)])
def test_tile_grid_matches_jax(h, w, tile, overlap):
    got, want = TT.make_tile_grid(h, w, tile, overlap), JT.make_tile_grid(h, w, tile, overlap)
    assert (got.offsets_i, got.offsets_j, got.num_tiles) == (
        want.offsets_i, want.offsets_j, want.num_tiles)
    np.testing.assert_array_equal(TT._border_weight(tile), JT._border_weight(tile))


@pytest.mark.parametrize("h,w,overlap", [(16, 12, 0.5), (21, 13, 0.25)])
def test_unfold_fold_match_jax(h, w, overlap):
    rng = np.random.default_rng(h)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    tg, jg = TT.make_tile_grid(h, w, TILE, overlap), JT.make_tile_grid(h, w, TILE, overlap)
    tiles = TT.unfold(torch.from_numpy(x), tg)
    np.testing.assert_allclose(tiles.numpy(), np.asarray(JT.unfold(jnp.asarray(x), jg)),
                               rtol=0, atol=FOLD_ATOL)
    y = rng.normal(size=tuple(tiles.shape)).astype(np.float32)
    np.testing.assert_allclose(TT.fold(torch.from_numpy(y), tg).numpy(),
                               np.asarray(JT.fold(jnp.asarray(y), jg)), rtol=0, atol=FOLD_ATOL)
    # fold of an unfold is the identity (the weights normalize to 1)
    np.testing.assert_allclose(TT.fold(tiles, tg).numpy(), x, rtol=0, atol=FOLD_ATOL)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs(**UNET)
    jmodel, params = random_params(jcfg, seed=3, cond_channels=3)
    tmodel = port_model(tcfg, params)

    def jfn(x, t, c, y):
        return jmodel.apply(params, x, t, cond=c, y=y)

    def tfn(x, t, c, y):
        with torch.no_grad():
            return tmodel(x, t, cond=c, y=y)

    return jfn, tfn


@pytest.mark.parametrize("inpaint", [False, True])
def test_tiled_ddim_eta0_matches_jax(models, inpaint):
    jfn, tfn = models
    rng = np.random.default_rng(7)
    cond = rng.uniform(-1, 1, size=(N, H, W, 3)).astype(np.float32)
    x0 = rng.uniform(-1, 1, size=(N, H, W, 3)).astype(np.float32)
    mask = (rng.uniform(size=(N, H, W, 1)) > 0.5).astype(np.float32) if inpaint else None
    jd = JGD.create(timesteps=50, image_size=TILE, in_channels=3)
    key = jax.random.PRNGKey(2)
    ref = JT.tiled_ddim_sample(jd, jfn, key, N, H, W, num_steps=STEPS, cond=jnp.asarray(cond),
                               mask=None if mask is None else jnp.asarray(mask),
                               x0=jnp.asarray(x0) if inpaint else None).x
    # replay the JAX sampler's draws: x_T from the first key of its split,
    # the per-step mask noise from the (key, eta, mask) splits of the second
    init_key, k = jax.random.split(key)
    shape = (N, H, W, 3)
    x_T = np.array(jax.random.normal(init_key, shape, jnp.float32))
    mask_noise = []
    for _ in range(STEPS):
        k, _, mk = jax.random.split(k, 3)
        mask_noise.append(np.array(jax.random.normal(mk, shape, jnp.float32)))
    td = TGD.create(timesteps=50, image_size=TILE, in_channels=3)
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    out = TT.tiled_ddim_sample(td, tfn, N, H, W, device="cpu", num_steps=STEPS,
                               cond=as_t(cond), mask=as_t(mask),
                               x0=as_t(x0) if inpaint else None, x_T=torch.from_numpy(x_T),
                               noise_fn=lambda i, role: torch.from_numpy(mask_noise[i]))
    assert out.x.shape == shape and out.x.dtype == torch.float32
    assert rel_err(out.x, ref) <= TRAJ_TOL


# the tiled samplers with CFG and a DeepCache-shaped stateful denoiser on the
# closed-form denoiser of torch_parity, tiles in chunks of 5 (one state a
# chunk): DDIM with image-CFG and the rescale, Heun on the flow ODE with
# label-CFG; (sampler, steps, guidance)
GUIDED = {"ddim-image-cfg-rescale": ("ddim", STEPS, dict(guidance_scale=3.0,
                                                          guidance_rescale=0.7)),
          "flow-heun-label-cfg-rescale": ("flow", 4, dict(guidance_scale=2.0,
                                                           guidance_rescale=0.5))}


@pytest.mark.parametrize("case", sorted(GUIDED))
def test_tiled_guided_stateful_matches_jax(case):
    sampler, steps, gkw = GUIDED[case]
    rng = np.random.default_rng(11)
    shape = (N, H, W, 3)
    cond = rng.uniform(-1, 1, size=shape).astype(np.float32)
    kw = dict(gkw, cond=cond, tile_batch=5,
              model_state=np.zeros((2 * 5, TILE, TILE, 3), np.float32))
    if sampler == "ddim":
        kw.update(uncond=np.zeros_like(cond))
    else:
        kw.update(y=np.array([1, 3], np.int32), y_uncond=np.array([4, 4], np.int32),
                  method="heun")
    as_j = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    as_t = lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    key = jax.random.PRNGKey(8)
    jkw = {k: as_j(v) for k, v in kw.items()}
    tkw = {k: as_t(v) for k, v in kw.items()}
    if sampler == "ddim":
        ref = JT.tiled_ddim_sample(JGD.create(timesteps=50, image_size=TILE, in_channels=3),
                                   cached_denoiser(jnp), key, N, H, W, num_steps=steps,
                                   **jkw).x
        init_key = jax.random.split(key)[0]  # x_T, the first key of the split
        out = TT.tiled_ddim_sample(TGD.create(timesteps=50, image_size=TILE, in_channels=3),
                                   cached_denoiser(torch), N, H, W, device="cpu",
                                   num_steps=steps, x_T=_normal(init_key, shape), **tkw).x
    else:
        flow = dict(image_size=TILE, in_channels=3, cond_type="concat")
        ref = JT.tiled_flow_sample(JFM.create(**flow), cached_denoiser(jnp), key, N, H, W,
                                   num_steps=steps, **jkw).x
        init_key = jax.random.split(jax.random.fold_in(key, 3))[0]
        out = TT.tiled_flow_sample(TFM.create(**flow), cached_denoiser(torch), N, H, W,
                                   device="cpu", num_steps=steps,
                                   x_T=_normal(init_key, shape), **tkw).x
    assert out.shape == shape and out.dtype == torch.float32
    assert rel_err(out, ref) <= TRAJ_TOL


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))


def test_tile_batch_chunks_and_refusals(models):
    """Chunks of tile_batch tiles give the flat batch's model outputs, with
    CFG too; a stateful denoiser keeps one state a chunk; the tiled bridge
    refuses to run without its source scene."""
    _, tfn = models
    td = TGD.create(timesteps=50, image_size=TILE, in_channels=3)
    g = torch.Generator().manual_seed(0)
    cond = torch.rand(N, H, W, 3, generator=g) * 2 - 1
    grid = TT.make_tile_grid(H, W, TILE)
    x_tiles = TT.unfold(torch.randn(N, H, W, 3, generator=g), grid)
    flat = TT.make_tiled_denoiser(tfn, grid, TILE, N, cond=cond)(x_tiles, 30)
    chunked = TT.make_tiled_denoiser(tfn, grid, TILE, N, cond=cond, tile_batch=5)(x_tiles, 30)
    assert flat.shape == (N, grid.num_tiles, TILE, TILE, 3)
    torch.testing.assert_close(chunked, flat, rtol=1e-5, atol=1e-5)
    kw = dict(device="cpu", num_steps=3, cond=cond, eta=0.5)
    out = TT.tiled_ddim_sample(td, tfn, N, H, W, tile_batch=5, generator=g, **kw).x
    assert out.shape == (N, H, W, 3) and torch.isfinite(out).all()
    gkw = dict(cond=cond, guidance_scale=3.0, guidance_rescale=0.5, uncond=torch.zeros_like(cond))
    flat = TT.make_tiled_denoiser(tfn, grid, TILE, N, **gkw)(x_tiles, 30)
    chunked = TT.make_tiled_denoiser(tfn, grid, TILE, N, tile_batch=5, **gkw)(x_tiles, 30)
    torch.testing.assert_close(chunked, flat, rtol=1e-5, atol=1e-5)
    seen = []

    def stateful(x, t, c, y, st, i):
        seen.append((x.shape[0], st, i))
        return tfn(x, t, c, y), st + 1

    denoise = TT.make_tiled_denoiser(stateful, grid, TILE, N, cond=cond, tile_batch=5,
                                     model_state=0)
    for i in range(2):
        denoise(x_tiles, 30, i)
    n_flat = N * grid.num_tiles  # 12 tiles: chunks of 5, 5 and 2
    assert seen == [(5, 0, 0), (5, 0, 0), (n_flat - 10, 0, 0), (5, 1, 1), (5, 1, 1),
                    (n_flat - 10, 1, 1)]
    from eo_diffusion_torch.diffusion.bridge import BrownianBridge

    with pytest.raises(AssertionError, match="source scene"):
        TT.tiled_bridge_sample(BrownianBridge.create(TILE, timesteps=50), tfn, N, H, W,
                               device="cpu")
