"""The port's DeepCache split and PAG against the JAX package's (f32, CPU).

A tiny UNet (legacy head order, attention at both levels) and a tiny DiT
(new head order), every parameter randomised and carried over. One jitted
JAX function returns the UNet's ``return_deep`` output and feature, its
partial forward on that feature, and the PAG-guided predictions of the UNet
and the DiT. The identity branch of ``attention_from_qkv`` is held against
JAX's in both head orders; ``deepcache_model_fn`` drives a DDIM run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion.deepcache import deepcache_model_fn
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_torch.diffusion.pag import pag_model_fn as t_pag
from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.models import unet as TU
from eo_diffusion_torch.ops import attention as TA
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params
from eo_diffusion_tpu.diffusion.pag import pag_model_fn as j_pag
from eo_diffusion_tpu.models import dit as JD
from eo_diffusion_tpu.ops import attention as JA
from torch_parity import (configs, one_torch_thread, port_model, random_dit_params,  # noqa: F401
                          random_params, rel_err)

# forwards: max |port - jax| / max |jax| (DESIGN.md:52-54)
REL_TOL = 1e-5
UNET = dict(image_size=8, in_channels=3, model_channels=16, out_channels=3, num_res_blocks=1,
            attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=2)
DIT = dict(image_size=8, in_channels=3, out_channels=3, patch_size=2, hidden_size=32, depth=1,
           num_heads=2)
PAG = 2.0


@pytest.fixture(scope="module")
def twin():
    jcfg, tcfg = configs(**UNET)
    jmodel, params = random_params(jcfg, seed=21)
    jdit_cfg = JD.DiTConfig(**DIT)
    jdit, dparams = random_dit_params(jdit_cfg, seed=22)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    t = np.array([700, 30], np.int32)
    tf = np.array([700.0, 30.0], np.float32)

    @jax.jit
    def run(params, dparams, x, t, tf):
        out, deep = jmodel.apply(params, x, t, return_deep=True)
        part = jmodel.apply(params, x, t, deep_cache=deep)
        pag_u = j_pag(lambda x, t, c, y: jmodel.apply(params, x, t), PAG)(x, t, None, None)
        pag_d = j_pag(lambda x, t, c, y: jdit.apply(dparams, x, t), PAG)(x, tf, None, None)
        return out, deep, part, pag_u, pag_d

    ref = [np.asarray(a) for a in run(params, dparams, jnp.asarray(x), jnp.asarray(t),
                                      jnp.asarray(tf))]
    unet = port_model(tcfg, params)
    dit = TD.DiT(TD.DiTConfig(**DIT))
    dit.load_state_dict(dit_state_dict_from_jax_params(dparams, dit.config), strict=True)
    inputs = (torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(tf))
    return unet, dit.eval(), inputs, ref


@torch.no_grad()
def test_deepcache_split_matches_jax(twin):
    unet, _, (x, t, _), (out, deep, part, _, _) = twin
    full, feat = unet(x, t, return_deep=True)
    assert rel_err(full, out) <= REL_TOL and rel_err(feat, deep) <= REL_TOL
    assert feat.shape == deep.shape == (2, 8, 8, 32)  # the h entering the first shallow block
    partial = unet(x, t, deep_cache=feat)
    assert rel_err(partial, part) <= REL_TOL
    # partial(x, t, cache=full(x, t).deep) is full(x, t), bit for bit
    assert torch.equal(partial, full) and torch.equal(full, unet(x, t))
    # another split: the stem alone is shallow
    full1, feat1 = unet(x, t, return_deep=True, cache_depth=1)
    assert torch.equal(unet(x, t, deep_cache=feat1, cache_depth=1), full1)
    with pytest.raises(AssertionError):
        unet(x, t, return_deep=True, cache_depth=len(unet.input_blocks))


@pytest.mark.parametrize("new_order", [False, True])
def test_identity_attention_matches_jax(new_order):
    qkv = np.random.default_rng(int(new_order)).normal(size=(2, 6, 3 * 8)).astype(np.float32)
    with JA.identity_attention():
        want = JA.attention_from_qkv(jnp.asarray(qkv), 2, new_order=new_order)
    h0 = TA.identity_attention_hits()
    with TA.identity_attention():
        got = TA.attention_from_qkv(torch.from_numpy(qkv), 2, new_order=new_order)
    assert TA.identity_attention_hits() == h0 + 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    v = TA.split_qkv(torch.from_numpy(qkv), 2, new_order)[2]
    torch.testing.assert_close(got, v.reshape(2, 6, 8), rtol=0, atol=0)
    # outside the context the map is the softmax again
    assert not torch.equal(TA.attention_from_qkv(torch.from_numpy(qkv), 2, new_order), got)


@torch.no_grad()
def test_pag_matches_jax(twin):
    unet, dit, (x, t, tf), (_, _, _, pag_u, pag_d) = twin
    plan = TU.build_unet_plan(unet.config)
    sites = sum(s.kind == "attn" for blk in (*plan.input_blocks, plan.middle_block,
                                             *plan.output_blocks) for s in blk)
    h0 = TA.identity_attention_hits()
    got = t_pag(lambda x, t, c, y: unet(x, t), PAG)(x, t, None, None)
    assert rel_err(got, pag_u) <= REL_TOL
    assert TA.identity_attention_hits() == h0 + sites == h0 + 7  # one a UNet attention block
    got = t_pag(lambda x, t, c, y: dit(x, t), PAG)(x, tf, None, None)
    assert rel_err(got, pag_d) <= REL_TOL
    assert TA.identity_attention_hits() == h0 + sites + DIT["depth"]


@torch.no_grad()
def test_pag_tail_scale_zero_and_no_op_guard(twin):
    unet, _, (x, t, _), _ = twin
    fn = lambda x, t, c, y: unet(x, t)
    assert t_pag(fn, 0.0) is fn
    # a learned-variance tail passes through from the plain call
    tail = lambda x, t, c, y: torch.cat([unet(x, t), 2.0 * x], dim=-1)
    both = t_pag(tail, PAG)(x, t, None, None)
    torch.testing.assert_close(both[..., 3:], 2.0 * x, rtol=0, atol=0)
    torch.testing.assert_close(both[..., :3], t_pag(fn, PAG)(x, t, None, None), rtol=0, atol=0)
    # a denoiser that routes no attention through attention_from_qkv (the
    # UNet's middle block always holds one): PAG would be a silent no-op
    conv = torch.nn.Conv2d(3, 3, 3, padding=1)
    no_attn = lambda x, t, c, y: conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="no-op"):
        t_pag(no_attn, PAG)(x, t, None, None)


@torch.no_grad()
def test_deepcache_ddim_refreshes_every_k(twin):
    """DDIM through deepcache_model_fn: full calls at steps 0, k, 2k, ...,
    the shallow blocks alone between; k = 1 is the plain run, bit for bit,
    and under CFG the cached feature is the doubled batch's."""
    unet, _, (x, _, _), _ = twin
    seen = []
    orig = unet.forward

    def spy(*a, **kw):
        seen.append(("partial" if kw.get("deep_cache") is not None else "full", a[0].shape[0]))
        return orig(*a, **kw)

    td = TGD.create(timesteps=100, image_size=8, in_channels=3)
    kw = dict(device="cpu", num_steps=10, x_T=x)
    plain = td.ddim_sample(lambda x, t, c, y: unet(x, t), 2, **kw).x
    fn1, st = deepcache_model_fn(unet, refresh_every=1)
    torch.testing.assert_close(td.ddim_sample(fn1, 2, model_state=st, **kw).x, plain,
                               rtol=0, atol=0)
    unet.forward = spy
    try:
        fn3, st = deepcache_model_fn(unet, refresh_every=3)
        out = td.ddim_sample(fn3, 2, model_state=st, **kw).x
        assert [k for k, _ in seen] == ["full", "partial", "partial"] * 3 + ["full"]
        assert torch.isfinite(out).all() and not torch.equal(out, plain)
        seen.clear()
        y_fn, st = deepcache_model_fn(unet, refresh_every=2)
        td.ddim_sample(lambda x, t, c, y, s, i: y_fn(x, t, None, None, s, i), 2,
                       model_state=st, guidance_scale=3.0, cond=torch.zeros(2, 8, 8, 1),
                       uncond=torch.ones(2, 8, 8, 1), **kw)
        assert [b for _, b in seen] == [4] * 10
    finally:
        unet.forward = orig
