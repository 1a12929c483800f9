"""Two pieces of the latent stack against the JAX package, f32 on the CPU:
``tiled_flow_sample`` (eo_diffusion_torch.diffusion.tiled) over a scene
larger than a tiny concat-conditioned DiT's tile, Euler, Heun and Heun with
full-scene inpainting, the JAX sampler's own draws replayed (x_T from its
key split, the mask noise through ``noise_fn``); and the DiT's
cross-attention (``CrossAttentionTokens``, ``DiTConfig.context_dim``),
alone and inside a DiT, every parameter randomised. One jitted JAX function
returns all five."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion import tiled as TT
from eo_diffusion_torch.diffusion.flow import FlowMatching as TFM
from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params
from eo_diffusion_tpu.diffusion import tiled as JT
from eo_diffusion_tpu.diffusion.flow import FlowMatching as JFM
from eo_diffusion_tpu.models import dit as JD
from torch_parity import fill_params, one_torch_thread, random_dit_params, rel_err  # noqa: F401

# whole-trajectory f32 sampler parity and the cross-attention forward:
# max |torch - jax| / max |jax|
TRAJ_TOL = 5e-5
REL_TOL = 1e-5
TILE, H, W, N, C = 8, 16, 12, 2, 3
TILED_DIT = dict(image_size=TILE, in_channels=2 * C, out_channels=C, patch_size=2,
                 hidden_size=32, depth=1, num_heads=2)
CTX, L = 6, 5  # context width and tokens
CTX_DIT = dict(image_size=TILE, in_channels=C, out_channels=C, patch_size=2, hidden_size=32,
               depth=2, num_heads=2, context_dim=CTX)
# case -> (method, steps, inpainting)
CASES = {"euler": ("euler", 4, False), "heun": ("heun", 4, False),
         "heun_mask": ("heun", 3, True)}


@pytest.fixture(scope="module")
def twin():
    jdit, params = random_dit_params(JD.DiTConfig(**TILED_DIT), seed=41, cond_channels=C)
    jctx = JD.DiT(JD.DiTConfig(**CTX_DIT))
    ctx_shapes = jax.eval_shape(jctx.init, jax.random.PRNGKey(0), jnp.zeros((1, TILE, TILE, C)),
                                jnp.zeros((1,)), context=jnp.zeros((1, L, CTX)))
    ctx_params = fill_params(ctx_shapes, seed=42)
    rng = np.random.default_rng(5)
    d = dict(cond=rng.uniform(-1, 1, size=(N, H, W, C)), x0=rng.uniform(-1, 1, size=(N, H, W, C)),
             mask=(rng.uniform(size=(N, H, W, 1)) > 0.5), x=rng.normal(size=(N, TILE, TILE, C)),
             t=np.array([990.0, 12.5]), context=rng.normal(size=(N, L, CTX)),
             tokens=rng.normal(size=(N, (TILE // 2) ** 2, 32)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    key = jax.random.PRNGKey(6)
    flow = JFM.create(image_size=TILE, in_channels=C, cond_type="concat")

    @jax.jit
    def run(params, ctx_params, cond, x0, mask, x, t, context, tokens):
        fn = lambda xx, tt, c, y: jdit.apply(params, xx, tt, cond=c, y=y)
        trajs = {name: JT.tiled_flow_sample(flow, fn, key, N, H, W, num_steps=steps,
                                            method=method, cond=cond,
                                            mask=mask if inpaint else None,
                                            x0=x0 if inpaint else None).x
                 for name, (method, steps, inpaint) in CASES.items()}
        cross = JD.CrossAttentionTokens(2, jnp.float32).apply(
            {"params": ctx_params["params"]["block_0"]["cross"]}, tokens, context)
        return trajs, cross, jctx.apply(ctx_params, x, t, context=context)

    ref = jax.tree.map(np.asarray, run(params, ctx_params,
                                       **{k: jnp.asarray(v) for k, v in d.items()}))
    # the JAX sampler's draws: x_T from init_rng, step i's mask eps from
    # fold_in(mask_rng, i) (diffusion/tiled.py:350, :376)
    init_rng, mask_rng = jax.random.split(jax.random.fold_in(key, 3))
    shape = (N, H, W, C)
    x_T = np.array(jax.random.normal(init_rng, shape, jnp.float32))
    mask_noise = [np.array(jax.random.normal(jax.random.fold_in(mask_rng, i), shape,
                                             jnp.float32)) for i in range(3)]
    tdit = TD.DiT(TD.DiTConfig(**TILED_DIT))
    tdit.load_state_dict(dit_state_dict_from_jax_params(params, tdit.config), strict=True)
    tctx = TD.DiT(TD.DiTConfig(**CTX_DIT))
    tctx.load_state_dict(dit_state_dict_from_jax_params(ctx_params, tctx.config), strict=True)
    draws = dict(x_T=torch.from_numpy(x_T), mask_noise=[torch.from_numpy(m) for m in mask_noise])
    return (tdit.eval(), tctx.eval(), {k: torch.from_numpy(v) for k, v in d.items()}, draws,
            ref)


@pytest.mark.parametrize("case", sorted(CASES))
@torch.no_grad()
def test_tiled_flow_sample_matches_jax(twin, case):
    tdit, _, d, draws, (trajs, _, _) = twin
    method, steps, inpaint = CASES[case]
    calls = []

    def fn(x, t, c, y):
        calls.append(t)
        return tdit(x, t, cond=c, y=y)

    flow = TFM.create(image_size=TILE, in_channels=C, cond_type="concat")
    out = TT.tiled_flow_sample(
        flow, fn, N, H, W, device="cpu", num_steps=steps, method=method, cond=d["cond"],
        mask=d["mask"] if inpaint else None, x0=d["x0"] if inpaint else None,
        x_T=draws["x_T"], noise_fn=lambda i, role: draws["mask_noise"][i])
    assert out.x.shape == (N, H, W, C) and out.x.dtype == torch.float32
    assert rel_err(out.x, trajs[case]) <= TRAJ_TOL
    # one stitched call a step, two for Heun but the last; float times * 1000
    assert len(calls) == (2 * steps - 1 if method == "heun" else steps)
    grid = TT.make_tile_grid(H, W, TILE)
    assert all(t.dtype == torch.float32 and t.shape == (N * grid.num_tiles,) for t in calls)
    assert float(calls[0][0]) == 1000.0
    if inpaint:  # the final paste keeps the known pixels verbatim
        known = d["mask"].expand(N, H, W, C) > 0
        torch.testing.assert_close(out.x[known], d["x0"][known], rtol=0, atol=0)


def test_tiled_flow_tile_batch_and_refusals(twin):
    """Chunks of tiles give the whole batch's trajectory, with CFG and a
    stateful denoiser too; an unknown integrator raises."""
    tdit, _, d, draws, _ = twin
    fn = lambda x, t, c, y: tdit(x, t, cond=c, y=y)
    flow = TFM.create(image_size=TILE, in_channels=C, cond_type="concat")
    kw = dict(device="cpu", num_steps=2, cond=d["cond"], x_T=draws["x_T"])
    with torch.no_grad():
        whole = TT.tiled_flow_sample(flow, fn, N, H, W, **kw).x
        chunked = TT.tiled_flow_sample(flow, fn, N, H, W, tile_batch=5, **kw).x
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-5)
    # CFG and a stateful denoiser: chunks give the whole batch's result, each
    # chunk with its own state; both Heun calls of a step see its index
    gkw = dict(guidance_scale=2.0, uncond=torch.zeros_like(d["cond"]))
    with torch.no_grad():
        whole = TT.tiled_flow_sample(flow, fn, N, H, W, method="heun", **kw, **gkw).x
        steps = []
        stateful = lambda x, t, c, y, st, i: (steps.append((st, i)) or fn(x, t, c, y), st + 1)
        chunked = TT.tiled_flow_sample(flow, stateful, N, H, W, method="heun", tile_batch=5,
                                       model_state=0, **kw, **gkw).x
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-5)
    chunks = -(-N * TT.make_tile_grid(H, W, TILE).num_tiles // 5)
    assert steps == [(k, i) for k, i in ((0, 0), (1, 0), (2, 1)) for _ in range(chunks)]
    with pytest.raises(ValueError, match="euler"):
        TT.tiled_flow_sample(flow, fn, N, H, W, method="rk4", **kw)


@torch.no_grad()
def test_cross_attention_matches_jax(twin):
    _, tctx, d, _, (_, cross, out) = twin
    got = tctx.block_0.cross(d["tokens"], d["context"])
    assert np.abs(cross).max() > 0.1 and rel_err(got, cross) <= REL_TOL
    got = tctx(d["x"], d["t"], context=d["context"])
    assert got.shape == (N, TILE, TILE, C) and rel_err(got, out) <= REL_TOL


def test_cross_attention_starts_at_zero_and_needs_context():
    """A fresh cross-attention adds exactly zero (zero-initialised
    proj_out), and a DiT with context_dim refuses a call without context."""
    cfg = TD.DiTConfig(**CTX_DIT)
    block = TD.DiT(cfg).block_0
    tokens, ctx = torch.randn(N, 16, 32), torch.randn(N, L, CTX)
    assert torch.equal(block.cross(tokens, ctx), torch.zeros_like(tokens))
    assert [n for n, _ in block.named_children()] == [
        "ada_mod", "qkv", "proj_out", "cross", "mlp_in", "mlp_out"]
    with pytest.raises(AssertionError, match="context"):
        TD.DiT(cfg)(torch.zeros(1, TILE, TILE, C), torch.zeros(1))
