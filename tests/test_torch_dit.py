"""The port's DiT (eo_diffusion_torch.models.dit) against the JAX package's, f32
on the CPU: a tiny DiT with class labels (and the CFG null row) and concat
conditioning, every parameter randomised, carried over by
``dit_state_dict_from_jax_params``. One jitted JAX function returns the
forward and its stages (embed, condition, final)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params, randomize_parameters
from eo_diffusion_tpu.models import dit as JD
from torch_parity import one_torch_thread, random_dit_params, rel_err  # noqa: F401

# forward rel err max |torch - jax| / max |jax| (DESIGN.md:52-54)
REL_TOL = 1e-5
COND = 2  # concat-conditioning channels
KW = dict(image_size=16, in_channels=3 + COND, out_channels=3, patch_size=4, hidden_size=64,
          depth=2, num_heads=4, num_classes=3, class_dropout_prob=0.1)


@pytest.fixture(scope="module")
def twin():
    """The JAX DiT's outputs on seeded inputs, and the port's DiT with the
    same parameters."""
    jcfg, tcfg = JD.DiTConfig(**KW), TD.DiTConfig(**KW)
    jmodel, params = random_dit_params(jcfg, seed=5, cond_channels=COND)
    rng = np.random.default_rng(0)
    inputs = dict(x=rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
                  t=np.array([999.0, 123.4], np.float32),  # fractional, as flow feeds it
                  cond=rng.normal(size=(2, 16, 16, COND)).astype(np.float32),
                  y=np.array([1, 3], np.int32),  # 3 = the null row
                  h=rng.normal(size=(2, 16, 64)).astype(np.float32))

    @jax.jit
    def run(params, x, t, cond, y, h):
        out = jmodel.apply(params, x, t, cond=cond, y=y)
        emb = jmodel.apply(params, x, cond, method=JD.DiT.embed)
        c = jmodel.apply(params, t, y, method=JD.DiT.condition)
        return out, emb, c, jmodel.apply(params, h, c, method=JD.DiT.final)

    ref = dict(zip(("out", "embed", "condition", "final"),
                   (np.asarray(a) for a in run(params, **{k: jnp.asarray(v)
                                                          for k, v in inputs.items()}))))
    model = TD.DiT(tcfg)
    model.load_state_dict(dit_state_dict_from_jax_params(params, tcfg), strict=True)
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    tin["y"] = tin["y"].long()
    return model.eval(), params, tcfg, tin, ref


def test_forward_matches_jax(twin):
    model, _, _, tin, ref = twin
    with torch.no_grad():
        out = model(tin["x"], tin["t"], cond=tin["cond"], y=tin["y"])
    assert out.shape == (2, 16, 16, 3) and out.dtype == torch.float32
    assert np.abs(ref["out"]).max() > 0.1  # no zero-initialised layer left
    assert rel_err(out, ref["out"]) <= REL_TOL


@pytest.mark.parametrize("stage", ["embed", "condition", "final"])
def test_stages_match_jax(twin, stage):
    """embed (concat, patchify in (py, px, c) order, positions), condition
    (timestep MLP and the label table with its null row) and final (adaLN,
    head, unpatchify) one by one."""
    model, _, _, tin, ref = twin
    x = torch.cat([tin["x"], tin["cond"]], dim=-1)
    with torch.no_grad():
        got = {"embed": lambda: model.embed(tin["x"], tin["cond"]),
               "condition": lambda: model.condition(tin["t"], tin["y"]),
               "final": lambda: model.final(tin["h"], model.condition(tin["t"], tin["y"]))
               }[stage]()
    assert got.shape == ref[stage].shape
    assert rel_err(got, ref[stage]) <= REL_TOL
    if stage == "embed":  # the patch order is the JAX package's reshape
        assert torch.equal(TD.unpatchify(TD.patchify(x, 4), 4, 4), x)
        tok = x.reshape(2, 4, 4, 4, 4, 5).permute(0, 1, 3, 2, 4, 5).reshape(2, 16, 80)
        assert torch.equal(TD.patchify(x, 4), tok)


def test_posemb_and_modulated_ln_match_jax():
    rng = np.random.default_rng(1)
    pos = TD.posemb_sincos_2d(4, 6, 32)
    assert pos.shape == (24, 32)
    np.testing.assert_allclose(pos.numpy(), np.asarray(JD.posemb_sincos_2d(4, 6, 32)),
                               rtol=0, atol=1e-6)
    x, shift, scale = (rng.normal(size=s).astype(np.float32) * 3
                       for s in ((2, 5, 64), (2, 64), (2, 64)))
    ref = np.asarray(JD._modulated_ln(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale)))
    got = TD.modulated_ln(*(torch.from_numpy(a) for a in (x, shift, scale)))
    assert rel_err(got, ref) <= REL_TOL


def test_weight_converter_names_every_leaf(twin):
    model, params, tcfg, _, _ = twin
    sd = dit_state_dict_from_jax_params(params, tcfg)
    assert set(sd) == set(model.state_dict())
    assert "block_1.qkv.weight" in sd and sd["block_1.qkv.weight"].shape == (192, 64)
    assert sd["label_embed.weight"].shape == (4, 64)  # 3 classes + the null row
    extra = {**params, "params": {**params["params"], "stray": {"kernel": np.zeros((1, 1))}}}
    with pytest.raises(KeyError):
        dit_state_dict_from_jax_params(extra, tcfg)


def test_randomize_leaves_no_zero_layer():
    model = randomize_parameters(TD.DiT(TD.DiTConfig(**KW)), seed=0)
    again = randomize_parameters(TD.DiT(TD.DiTConfig(**KW)), seed=0)
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert p.abs().max() > 0 and torch.equal(p, q), name


@pytest.mark.parametrize("option,queue", [("num_experts", 13), ("tome_ratio", 13),
                                          ("dual_time", 12)])
def test_unported_options_raise(option, queue):
    """MoE and ToMe raise naming queue 13; dual_time (queue 12) is ported: the
    DiT builds r's embedding MLP and takes (t, r) packed [N, 2]."""
    value = {"num_experts": 2, "tome_ratio": 0.5, "dual_time": True}[option]
    if queue == 12:
        model = TD.DiT(TD.DiTConfig(**KW, **{option: value}))
        assert {"r_embed_0.weight", "r_embed_1.weight"} <= set(model.state_dict())
        c = model.condition(torch.tensor([[500.0, 100.0], [20.0, 20.0]]),
                            torch.tensor([0, 1]))
        assert c.shape == (2, KW["hidden_size"]) and bool(torch.isfinite(c).all())
        return
    with pytest.raises(NotImplementedError, match=f"queue {queue}"):
        TD.DiT(TD.DiTConfig(**KW, **{option: value}))


@pytest.mark.parametrize("option,value", [("moe_top_k", 2), ("moe_every", 1),
                                          ("moe_capacity", 2.0), ("tome_mlp", True)])
def test_unported_moe_and_tome_fields_raise(option, value):
    with pytest.raises(NotImplementedError, match="queue 13"):
        TD.DiT(TD.DiTConfig(**KW, **{option: value}))
    defaults = TD.DiTConfig(**KW)  # the JAX defaults construct
    assert (defaults.moe_top_k, defaults.moe_every, defaults.moe_capacity,
            defaults.tome_mlp) == (1, 2, 1.25, False)
    TD.DiT(defaults)
