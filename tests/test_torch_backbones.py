"""The port's library-level backbones against the JAX package's, f32 on the
CPU, from one jitted JAX function: the UNet with cross-attention
(``context_dim``) through ``ConditioningWrapper``'s "crossattn" and "hybrid"
keys, ``ConvNextUNet`` in its three output modes and ``TinyUNet`` at 28 px;
the wrapper's dispatch of all six keys against JAX's on a recording model."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import unet as TU
from eo_diffusion_torch.models import unet_convnext as TCX
from eo_diffusion_torch.models import unet_tiny as TTY
from eo_diffusion_torch.models.wrapper import ConditioningWrapper
from eo_diffusion_torch.weights import flax_state_dict, state_dict_from_jax_params
from eo_diffusion_tpu.models import unet as JU
from eo_diffusion_tpu.models import unet_convnext as JCX
from eo_diffusion_tpu.models import unet_tiny as JTY
from eo_diffusion_tpu.models import wrapper as JW
from torch_parity import configs, fill_params, one_torch_thread, rel_err  # noqa: F401

REL_TOL = 1e-5
XATTN = dict(image_size=8, in_channels=3, model_channels=16, out_channels=3, num_res_blocks=1,
             attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2, context_dim=6)
# "hybrid": concat cond (2 channels), context and class labels together
HYBRID = dict(XATTN, in_channels=5, num_classes=3)
CONVNEXT = dict(dim=8, dim_mults=(1, 2), channels=3)
MODES = ({}, {"residual": True}, {"output_mean_scale": True})
TINY = dict(timesteps=50, time_embedding_dim=16, in_channels=1, out_channels=1, base_dim=8,
            dim_mults=(2,))


@pytest.fixture(scope="module")
def twin():
    rng = np.random.default_rng(0)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    d = dict(x=n(2, 8, 8, 3), cond=n(2, 8, 8, 2), ctx=[n(2, 3, 6), n(2, 2, 6)],
             y=np.array([0, 2], np.int32), t=np.array([3, 41], np.int32),
             xc=n(2, 16, 16, 3), xt=n(2, 28, 28, 1))
    jx, jh = JU.UNet(JU.UNetConfig(**XATTN)), JU.UNet(JU.UNetConfig(**HYBRID))
    ctx = np.concatenate(d["ctx"], 1)
    px = fill_params(jax.eval_shape(jx.init, jax.random.PRNGKey(0), d["x"], d["t"],
                                    context=ctx), 1)
    ph = fill_params(jax.eval_shape(jh.init, jax.random.PRNGKey(0), d["x"], d["t"],
                                    cond=d["cond"], y=d["y"], context=ctx), 2)
    jcx = [JCX.ConvNextUNet(JCX.ConvNextUNetConfig(**CONVNEXT, **m)) for m in MODES]
    pc = fill_params(jax.eval_shape(jcx[0].init, jax.random.PRNGKey(0), d["xc"], d["t"]), 3)
    jty = JTY.TinyUNet(JTY.TinyUNetConfig(**TINY))
    pt = fill_params(jax.eval_shape(jty.init, jax.random.PRNGKey(0), d["xt"], d["t"]), 4)

    @jax.jit
    def run(px, ph, pc, pt, x, cond, ctx, y, t, xc, xt):
        hyb = JW.ConditioningWrapper(jh, "hybrid")
        return (JW.ConditioningWrapper(jx, "crossattn")(px, x, t, {"c_crossattn": ctx}),
                hyb(ph, x, t, {"c_concat": [cond], "c_crossattn": ctx, "c_adm": y}),
                [m.apply(pc, xc, t) for m in jcx], jty.apply(pt, xt, t))

    ref = jax.tree.map(np.asarray, run(px, ph, pc, pt, d["x"], d["cond"], d["ctx"], d["y"],
                                       d["t"], d["xc"], d["xt"]))
    return dict(d=d, px=px, ph=ph, pc=pc, pt=pt, ref=ref)


def _unet(kw, params):
    _, tcfg = configs(**kw)
    model = TU.UNet(tcfg)
    model.load_state_dict(state_dict_from_jax_params(params, tcfg), strict=True)
    return model.eval()


@pytest.mark.parametrize("key", ["crossattn", "hybrid"])
def test_cross_attention_unet_through_the_wrapper(twin, key):
    d = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
             [torch.from_numpy(a) for a in v]) for k, v in twin["d"].items()}
    if key == "crossattn":
        model = _unet(XATTN, twin["px"])
        cond = {"c_crossattn": d["ctx"]}
        want = twin["ref"][0]
    else:
        model = _unet(HYBRID, twin["ph"])
        cond = {"c_concat": [d["cond"]], "c_crossattn": d["ctx"], "c_adm": d["y"].long()}
        want = twin["ref"][1]
    assert model.middle_block[1].xattn is not None
    with torch.no_grad():
        out = ConditioningWrapper(model, key)(d["x"], d["t"], cond)
    assert np.abs(want).max() > 0.1 and rel_err(out, want) <= REL_TOL
    with pytest.raises(AssertionError, match="context"):
        model(d["x"], d["t"])


class _Recorder:
    """A backbone that returns what it was called with (torch: ``model(...)``;
    JAX: ``model.apply(params, ...)``)."""

    def __call__(self, x, t, **kw):
        return {k: v for k, v in kw.items() if k != "train"}

    def apply(self, params, x, t, **kw):
        return self(x, t, **kw)


@pytest.mark.parametrize("key", [None, "concat", "crossattn", "adm", "hybrid", "spade"])
def test_wrapper_dispatch_matches_jax(key):
    rng = np.random.default_rng(1)
    parts = [rng.normal(size=(1, 2, 2, 1)).astype(np.float32) for _ in range(2)]
    toks = [rng.normal(size=(1, k, 3)).astype(np.float32) for k in (2, 1)]
    y = np.array([1])
    jout = JW.ConditioningWrapper(_Recorder(), key)(
        None, 0, 0, {"c_concat": parts, "c_crossattn": toks, "c_adm": y})
    tout = ConditioningWrapper(_Recorder(), key)(
        0, 0, {"c_concat": [torch.from_numpy(a) for a in parts],
               "c_crossattn": [torch.from_numpy(a) for a in toks], "c_adm": torch.from_numpy(y)})
    jout = {k: v for k, v in jout.items() if v is not None}
    tout = {k: v for k, v in tout.items() if v is not None}
    assert sorted(jout) == sorted(tout)
    for k in jout:
        np.testing.assert_array_equal(np.asarray(tout[k]), np.asarray(jout[k]))


@pytest.mark.parametrize("i", range(len(MODES)))
def test_convnext_unet_matches_jax(twin, i):
    cfg = TCX.ConvNextUNetConfig(**CONVNEXT, **MODES[i])
    model = TCX.ConvNextUNet(cfg)
    model.load_state_dict(flax_state_dict(model, twin["pc"]), strict=True)
    d = twin["d"]
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(d["xc"]), torch.from_numpy(d["t"]))
    want = twin["ref"][2][i]
    assert out.shape == want.shape and out.dtype == torch.float32
    assert np.abs(want).max() > 0.1 and rel_err(out, want) <= REL_TOL


def test_tiny_unet_matches_jax(twin):
    model = TTY.TinyUNet(TTY.TinyUNetConfig(**TINY))
    model.load_state_dict(flax_state_dict(model, twin["pt"]), strict=True)
    d = twin["d"]
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(d["xt"]), torch.from_numpy(d["t"]))
    want = twin["ref"][3]
    assert out.shape == (2, 28, 28, 1) and np.abs(want).max() > 0.1
    assert rel_err(out, want) <= REL_TOL


def test_channel_shuffle_order_and_configs():
    x = torch.arange(8.0).reshape(1, 1, 1, 8)
    assert TTY._channel_shuffle(x).flatten().tolist() == [0, 4, 1, 5, 2, 6, 3, 7]
    for tmod, jmod, cls in ((TCX, JCX, "ConvNextUNetConfig"), (TTY, JTY, "TinyUNetConfig")):
        assert ([f.name for f in dataclasses.fields(getattr(tmod, cls))]
                == [f.name for f in dataclasses.fields(getattr(jmod, cls))])
