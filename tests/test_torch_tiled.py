"""The port's tiled DDIM sampling (eo_diffusion_torch.diffusion.tiled) against
the JAX package's (f32, CPU): the tile grid, unfold/fold, and whole
trajectories of a tiny concat-conditioned UNet over a scene larger than its
tile. The JAX sampler's own draws are replayed into the port (x_T from its
key split, the RePaint mask noise through ``noise_fn``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion import tiled as TT
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_tpu.diffusion import tiled as JT
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from torch_parity import configs, one_torch_thread, port_model, random_params, rel_err  # noqa: F401

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


def test_tile_batch_chunks_and_refusals(models):
    """Chunks of tile_batch tiles give the flat batch's model outputs; the
    options of later slices raise and name their ROADMAP queue."""
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
    for bad, queue in ((dict(guidance_scale=2.0), 11), (dict(uncond=cond), 11),
                       (dict(y_uncond=torch.zeros(N, dtype=torch.long)), 11),
                       (dict(model_state={}), 11)):
        with pytest.raises(NotImplementedError, match=f"queue {queue}"):
            TT.tiled_ddim_sample(td, tfn, N, H, W, **kw, **bad)
    with pytest.raises(NotImplementedError, match="queue 10"):
        TT.tiled_flow_sample(None, tfn, None, N, H, W)
    with pytest.raises(NotImplementedError, match="queue 11"):
        TT.tiled_bridge_sample(None, tfn, None, N, H, W)
