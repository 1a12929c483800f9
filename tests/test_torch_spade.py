"""The port's SPADE UNet (eo_diffusion_torch.models.unet_spade) against the
JAX package's, f32 on the CPU, from one jitted JAX function: a forward with
a segmap of another size (12 px for an 8 px image, so that torch's
"nearest" and JAX's half-pixel rule would pick other pixels), the segmap
resizes themselves, and a 25-step DDIM trajectory (eta 0, shared x_T) of
the ``tiny-spade`` preset's model under the preset's process."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eo_diffusion_torch.cli.presets import build_denoiser, build_process, get_preset
from eo_diffusion_torch.models import unet_spade as TS
from eo_diffusion_torch.weights import flax_state_dict
from eo_diffusion_tpu.cli import presets as JP
from eo_diffusion_tpu.models import unet_spade as JS
from torch_parity import fill_params, one_torch_thread, rel_err  # noqa: F401

REL_TOL = 1e-5
TRAJ_TOL = 5e-5
SPADE = dict(image_size=8, in_channels=3, model_channels=16, out_channels=3, label_channels=2,
             num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
             spade_hidden=16)
RESIZES = ((8, 4), (64, 24), (12, 8), (12, 4), (5, 8))
STEPS = 25


@pytest.fixture(scope="module")
def twin():
    rng = np.random.default_rng(0)
    jm = JS.SpadeUNet(JS.SpadeUNetConfig(**SPADE))
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    seg = rng.uniform(size=(2, 12, 12, 2)).astype(np.float32)
    t = np.array([3, 41], np.int32)
    params = fill_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, t, cond=seg), 3)
    # the tiny-spade preset: its model (segmap of one channel) and its process
    jp = JP.get_preset("tiny-spade")
    jcfg = jp.model_config(cond_channels=1, bf16=False)
    jt = JS.SpadeUNet(jcfg)
    tparams = fill_params(jax.eval_shape(jt.init, jax.random.PRNGKey(0), x[:, :, :, :3], t,
                                         cond=seg[..., :1]), 4)
    jdiff = JP.build_process(jp, jp.timesteps, jp.image_size, cond_type="spade")
    tseg = (rng.uniform(size=(2, 8, 8, 1)) > 0.5).astype(np.float32)
    x_T = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    imgs = {(a, b): rng.normal(size=(1, a, a, 2)).astype(np.float32) for a, b in RESIZES}

    @jax.jit
    def run(params, tparams, x, t, seg, tseg, x_T, imgs):
        fn = lambda xx, tt, c, y: jt.apply(tparams, xx, tt, cond=c)
        traj = jdiff.ddim_sample(fn, jax.random.PRNGKey(1), 2, num_steps=STEPS, cond=tseg,
                                 x_T=x_T).x
        sizes = {k: jax.image.resize(v, (1, k[1], k[1], 2), "nearest") for k, v in imgs.items()}
        return jm.apply(params, x, t, cond=seg), traj, sizes

    ref = jax.tree.map(np.asarray, run(params, tparams, x, t, seg, tseg, x_T, imgs))
    return dict(x=x, t=t, seg=seg, tseg=tseg, x_T=x_T, imgs=imgs, params=params,
                tparams=tparams, ref=ref)


def test_spade_forward_matches_jax(twin):
    model = TS.SpadeUNet(TS.SpadeUNetConfig(**SPADE))
    model.load_state_dict(flax_state_dict(model, twin["params"]), strict=True)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(twin["x"]), torch.from_numpy(twin["t"]),
                           cond=torch.from_numpy(twin["seg"]))
    want = twin["ref"][0]
    assert out.shape == want.shape and np.abs(want).max() > 0.1
    assert rel_err(out, want) <= REL_TOL


@pytest.mark.parametrize("k", RESIZES)
def test_segmap_resize_is_jax_nearest(twin, k):
    """resize_nearest is jax.image.resize(..., "nearest") exactly, where
    torch's "nearest" is not (8 -> 4 and 12 -> 8 pick other pixels)."""
    img = torch.from_numpy(twin["imgs"][k])
    got = TS.resize_nearest(img, k[1], k[1])
    np.testing.assert_array_equal(got.numpy(), twin["ref"][2][k])
    if k in ((8, 4), (12, 8)):
        plain = F.interpolate(img.permute(0, 3, 1, 2), size=(k[1], k[1]),
                              mode="nearest").permute(0, 2, 3, 1)
        assert not torch.equal(plain, got)


def test_tiny_spade_ddim_trajectory_matches_jax(twin):
    """DDIM-25 (eta 0) of tiny-spade from the same x_T and segmap: the
    preset's SpadeUNet and process (spade -> concat), through build_denoiser."""
    preset = get_preset("tiny-spade")
    cfg = preset.model_config(bf16=False, cond_channels=1)
    assert isinstance(cfg, TS.SpadeUNetConfig) and cfg.label_channels == 1
    assert cfg.spade_hidden == 64 and cfg.dtype == torch.float32
    model = build_denoiser(cfg)
    model.load_state_dict(flax_state_dict(model, twin["tparams"]), strict=True)
    diff = build_process(preset, preset.timesteps, preset.image_size, cond_type="spade")
    assert diff.cond_type == "concat"
    with torch.no_grad():
        out = diff.ddim_sample(lambda x, t, c, y: model.eval()(x, t, cond=c), 2, device="cpu",
                               num_steps=STEPS, cond=torch.from_numpy(twin["tseg"]),
                               x_T=torch.from_numpy(twin["x_T"])).x
    want = twin["ref"][1]
    assert out.shape == want.shape and rel_err(out, want) <= TRAJ_TOL


def test_spade_config_and_presets_follow_jax():
    assert ([f.name for f in dataclasses.fields(TS.SpadeUNetConfig)]
            == [f.name for f in dataclasses.fields(JS.SpadeUNetConfig)])
    for name in ("spade64", "tiny-spade"):
        p, jp = get_preset(name), JP.get_preset(name)
        got = dataclasses.asdict(p.model_config(bf16=False, cond_channels=1))
        want = dataclasses.asdict(jp.model_config(bf16=False, cond_channels=1))
        got.pop("dtype"), want.pop("dtype")
        assert got == want
    with pytest.raises(AssertionError):
        get_preset("tiny-spade").model_config(num_classes=5, cond_channels=1)


def test_set_impl_reaches_the_spade_norms():
    model = TS.SpadeUNet(TS.SpadeUNetConfig(**SPADE)).set_impl(norm="plain")
    norms = [m for m in model.modules() if isinstance(m, TS.SPADEGroupNorm)]
    assert norms and all(m.impl == "plain" for m in norms)
