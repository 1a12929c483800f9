"""The port's UNet forward against eo_diffusion_tpu's UNet (f32, CPU), with
every weight randomized and carried across by state_dict_from_jax_params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import unet as TU
from torch_parity import configs, one_torch_thread, port_model, random_params, rel_err  # noqa: F401

# f32 forward: max |port - jax| / max |jax| (DESIGN.md:52-54)
REL_TOL = 1e-5

BASE = dict(image_size=8, in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
            num_heads=2)

CASES = {
    # legacy head order, additive timestep embedding, conv resampling
    "legacy": dict(),
    # (q|k|v)-major order, FiLM scale-shift, ResBlock up/down
    "new_order_film_updown": dict(use_new_attention_order=True,
                                  use_scale_shift_norm=True, resblock_updown=True),
    # concat cond (2 extra channels) and a class label
    "cond_and_class": dict(in_channels=5, num_classes=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    kw = {**BASE, **CASES[case]}
    cond_ch = kw["in_channels"] - 3
    jcfg, tcfg = configs(**kw)
    jmodel, params = random_params(jcfg, seed=len(case), cond_channels=cond_ch)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    t = np.array([3, 41], np.int32)
    cond = rng.normal(size=(2, 8, 8, cond_ch)).astype(np.float32) if cond_ch else None
    y = np.array([0, 2], np.int32) if jcfg.num_classes else None

    ref = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                cond=None if cond is None else jnp.asarray(cond),
                                y=None if y is None else jnp.asarray(y))
    model = port_model(tcfg, params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    cond=None if cond is None else torch.from_numpy(cond),
                    y=None if y is None else torch.from_numpy(y).long())
    assert out.shape == (2, 8, 8, 3) and out.dtype == torch.float32
    assert np.abs(np.asarray(ref)).max() > 0.1  # no zero-init layer left
    assert rel_err(out, ref) <= REL_TOL


def test_attention_block_count_of_clouds_unet():
    """The clouds UNet at 256 px attends 11 times per forward: 5 blocks at
    ds 4 (T 4096, D 48) and 6 at ds 8 (T 1024, D 64)."""
    plan = TU.build_unet_plan(TU.unet_clouds(256))
    attn = [s for blk in (*plan.input_blocks, plan.middle_block, *plan.output_blocks)
            for s in blk if s.kind == "attn"]
    assert len(attn) == 11
    assert sorted({(s.out_ch, s.num_heads) for s in attn}) == [(384, 8), (512, 8)]


def test_unported_options_raise():
    for kw in (dict(context_dim=8), dict(dual_time=True), dict(freeu=(1, 1, 1, 1))):
        with pytest.raises(NotImplementedError):
            TU.UNet(TU.UNetConfig(**BASE, **kw))
