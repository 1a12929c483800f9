"""The port's ControlNet adapters (eo_diffusion_torch.models.controlnet) and
the UNet's FreeU option against the JAX package's, f32 on the CPU, from one
jitted JAX function: an adapter written by the JAX ``save_controlnet`` loads
into the port and gives the same residuals and controlled forward; the
port's ``save_controlnet`` loads into JAX; ``init_from_base`` copies what
JAX's copies; FreeU in a full forward and in a DeepCache partial call."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import controlnet as TC
from eo_diffusion_torch.models import unet as TU
from eo_diffusion_torch.weights import controlnet_layout, state_dict_from_jax_params
from eo_diffusion_tpu.models import controlnet as JC
from eo_diffusion_tpu.models import unet as JU
from torch_parity import configs, fill_params, one_torch_thread, rel_err  # noqa: F401

REL_TOL = 1e-5
UNET = dict(image_size=8, in_channels=3, model_channels=16, out_channels=3, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2)
HINT = 2
FREEU = (1.2, 1.3, 0.9, 0.4)


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    rng = np.random.default_rng(0)
    jcfg, tcfg = configs(**UNET)
    x, x2 = (rng.normal(size=(2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    hint = rng.normal(size=(2, 8, 8, HINT)).astype(np.float32)
    t = np.array([3, 41], np.int32)
    base, cnet = JU.UNet(jcfg), JC.ControlNet(jcfg, hint_channels=HINT)
    freeu = JU.UNet(dataclasses.replace(jcfg, freeu=FREEU))
    bparams = fill_params(jax.eval_shape(base.init, jax.random.PRNGKey(0), x, t), 1)
    cparams = fill_params(jax.eval_shape(cnet.init, jax.random.PRNGKey(0), x, t, hint), 2)
    jdir = tmp_path_factory.mktemp("jax_adapter")
    JC.save_controlnet(str(jdir), cparams, {"hint_channels": HINT})

    @jax.jit
    def run(bparams, cparams, x, x2, t, hint):
        res, mid = cnet.apply(cparams, x, t, hint)
        controlled = base.apply(bparams, x, t, control=(res, mid))
        full, deep = freeu.apply(bparams, x, t, return_deep=True)
        return res, mid, controlled, full, freeu.apply(bparams, x2, t, deep_cache=deep)

    ref = jax.tree.map(np.asarray, run(bparams, cparams, x, x2, t, hint))
    return dict(x=x, x2=x2, hint=hint, t=t, bparams=bparams, cparams=cparams, jdir=str(jdir),
                tcfg=tcfg, jcfg=jcfg, ref=ref)


def _tensors(twin, *keys):
    return [torch.from_numpy(twin[k]) for k in keys]


def test_jax_written_adapter_gives_the_same_residuals(twin):
    cnet = TC.ControlNet(twin["tcfg"], HINT)
    assert TC.load_controlnet(twin["jdir"], cnet) == {"hint_channels": HINT}
    base = TU.UNet(twin["tcfg"])
    base.load_state_dict(state_dict_from_jax_params(twin["bparams"], twin["tcfg"]), strict=True)
    x, t, hint = _tensors(twin, "x", "t", "hint")
    res, mid, controlled, _, _ = twin["ref"]
    with torch.no_grad():
        got_res, got_mid = cnet.eval()(x, t, hint)
        assert len(got_res) == len(res)
        for a, b in zip(got_res, res):
            assert a.shape == b.shape and rel_err(a, b) <= REL_TOL
        assert rel_err(got_mid, mid) <= REL_TOL
        out = TC.controlled_apply_fn(base.eval(), cnet)(x, t, hint)
    assert rel_err(out, controlled) <= REL_TOL
    assert TC.control_param_count(cnet) == sum(int(np.prod(a.shape))
                                               for a in jax.tree.leaves(twin["cparams"]))


def test_port_written_adapter_loads_into_jax(twin, tmp_path):
    cnet = TC.ControlNet(twin["tcfg"], HINT)
    TC.load_controlnet(twin["jdir"], cnet)
    TC.save_controlnet(str(tmp_path), cnet, {"hint_channels": HINT, "by": "port"})
    template = jax.tree.map(jnp.zeros_like, twin["cparams"])
    got, meta = JC.load_controlnet(str(tmp_path), template)
    assert meta["by"] == "port"
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(twin["cparams"])):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_init_from_base_copies_what_jax_copies(twin):
    """A base whose stem took 2 concat channels: its stem stays fresh in both,
    every other encoder module and the time MLP are copied."""
    jcat, tcat = configs(**{**UNET, "in_channels": 5})
    base = JU.UNet(jcat)
    bparams = fill_params(jax.eval_shape(base.init, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8, 8, 5)), jnp.zeros((1,), jnp.int32)), 5)
    _, copied = JC.init_from_base(jax.tree.map(jnp.zeros_like, twin["cparams"]), bparams)
    tbase = TU.UNet(tcat)
    tbase.load_state_dict(state_dict_from_jax_params(bparams, tcat), strict=True)
    cnet = TC.ControlNet(twin["tcfg"], HINT)
    stem = cnet.input_blocks[0][0].weight.detach().clone()
    assert TC.init_from_base(cnet, tbase) == copied > 0
    assert torch.equal(cnet.input_blocks[0][0].weight, stem)  # shape mismatch: fresh
    assert torch.equal(cnet.middle_block[1].qkv.weight, tbase.middle_block[1].qkv.weight)
    assert float(cnet.zero_middle.weight.detach().abs().max()) == 0.0  # the zero heads stay zero


def test_layout_names_every_parameter(twin):
    cnet = TC.ControlNet(twin["tcfg"], HINT)
    names = [tname for _, tname, _, _ in controlnet_layout(twin["tcfg"], HINT)]
    assert sorted(names) == sorted(cnet.state_dict())


def test_freeu_matches_jax_in_full_and_deepcache_calls(twin):
    """FreeU (b1, b2, s1, s2) at the widths 32 and 16: a full forward, and a
    DeepCache partial call on another x, whose shallow joins re-weight too."""
    model = TU.UNet(dataclasses.replace(twin["tcfg"], freeu=FREEU))
    model.load_state_dict(state_dict_from_jax_params(twin["bparams"], twin["tcfg"]), strict=True)
    x, x2, t = _tensors(twin, "x", "x2", "t")
    *_, full, partial = twin["ref"]
    with torch.no_grad():
        out, deep = model.eval()(x, t, return_deep=True)
        assert rel_err(out, full) <= REL_TOL
        assert rel_err(model(x2, t, deep_cache=deep), partial) <= REL_TOL
        plain = TU.UNet(twin["tcfg"]).eval()
        plain.load_state_dict(model.state_dict())
        assert rel_err(plain(x, t), full) > 1e-3  # FreeU changed the output
        with pytest.raises(AssertionError, match="DeepCache"):
            model(x, t, return_deep=True, control=((), x))
