"""The port's AttentionPool2d and SuperResUNet against eo_diffusion_tpu's
(f32, CPU, seeded weights), from one jitted JAX function; the classifier's
own forward is held in test_torch_classifier_guidance.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import encoder_unet as TE
from eo_diffusion_torch.models import unet as TU
from eo_diffusion_torch.weights import state_dict_from_jax_params
from eo_diffusion_tpu.models import encoder_unet as JE
from eo_diffusion_tpu.models import unet as JU
from torch_parity import fill_params, one_torch_thread, rel_err  # noqa: F401

REL_TOL = 1e-5  # f32 forward: max |port - jax| / max |jax|
# the inner UNet's 5 input channels: 3 of x, 2 of the upsampled low-res cond
SR = dict(image_size=8, in_channels=5, model_channels=16, out_channels=3, num_res_blocks=1,
          channel_mult=(1,), num_heads=1)
POOL = dict(n=2, h=3, w=3, c=12, heads=3, out=5)


def _jax_refs(x, t, low, feat):
    """Params of the two JAX modules and their outputs on the inputs."""
    sr = JE.SuperResUNet(JU.UNetConfig(**SR))
    pool = JE.AttentionPool2d(num_heads=POOL["heads"], out_features=POOL["out"])
    p_sr = fill_params(jax.eval_shape(sr.init, jax.random.PRNGKey(0), x, t, low), 2)
    p_pool = fill_params(jax.eval_shape(pool.init, jax.random.PRNGKey(0), feat), 3)

    @jax.jit
    def run(p_sr, p_pool, x, t, low, feat):
        return sr.apply(p_sr, x, t, low), pool.apply(p_pool, feat)

    return (p_sr, p_pool), [np.asarray(o) for o in run(p_sr, p_pool, x, t, low, feat)]


@pytest.fixture(scope="module")
def twin():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    t = np.array([3, 41], np.int32)
    low = rng.normal(size=(2, 4, 4, 2)).astype(np.float32)
    feat = rng.normal(size=(POOL["n"], POOL["h"], POOL["w"], POOL["c"])).astype(np.float32)
    params, refs = _jax_refs(jnp.asarray(x), jnp.asarray(t), jnp.asarray(low), jnp.asarray(feat))
    return dict(x=x, t=t, low=low, feat=feat), params, refs


def test_config_fields_follow_jax():
    import dataclasses

    assert ([f.name for f in dataclasses.fields(TE.EncoderUNetConfig)]
            == [f.name for f in dataclasses.fields(JE.EncoderUNetConfig)])


def test_attention_pool_matches_jax(twin):
    inputs, (_, p_pool), (_, pooled) = twin
    p = p_pool["params"]
    pool = TE.AttentionPool2d(POOL["h"] * POOL["w"], POOL["c"], POOL["heads"], POOL["out"])
    sd = {"positional_embedding": p["positional_embedding"]}
    for name in ("qkv_proj", "c_proj"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p[name]["kernel"].T, p[name]["bias"]
    pool.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = pool(torch.from_numpy(inputs["feat"]))
    assert out.shape == (POOL["n"], POOL["out"]) and rel_err(out, pooled) <= REL_TOL


def test_superres_unet_matches_jax(twin):
    inputs, (p_sr, _), (sr_out, _) = twin
    model = TE.SuperResUNet(TU.UNetConfig(**SR)).eval()
    model.unet.load_state_dict(state_dict_from_jax_params(p_sr["params"]["unet"],
                                                          model.unet.config), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"]).long(),
                    low_res=torch.from_numpy(inputs["low"]))
    assert out.shape == (2, 8, 8, 3) and rel_err(out, sr_out) <= REL_TOL


@pytest.mark.parametrize("factor", [2, 4])
def test_nearest_resize_agrees_at_integer_factors(factor):
    """``jax.image.resize(..., "nearest")`` and ``F.interpolate(mode="nearest")``
    pick the same source pixel at integer factors, so SuperResUNet's cond is
    the JAX package's to the bit."""
    low = np.random.default_rng(factor).normal(size=(2, 3, 5, 2)).astype(np.float32)
    shape = (2, 3 * factor, 5 * factor, 2)
    ref = np.asarray(jax.image.resize(jnp.asarray(low), shape, "nearest"))
    out = torch.nn.functional.interpolate(torch.from_numpy(low).permute(0, 3, 1, 2),
                                          size=shape[1:3], mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(out.numpy(), ref)
