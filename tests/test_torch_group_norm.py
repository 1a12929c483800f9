"""The port's GroupNorm + FiLM + SiLU (eo_diffusion_torch/ops/group_norm.py)
against the JAX package's: the plain forward against ``group_norm_reference``
and against the Pallas kernel ``_gn_pallas`` in interpret mode (as
tests/test_ops.py runs it), and the autograd path's gradients against
``jax.vjp`` of ``group_norm_reference``, which is what ``_gn_bwd`` computes.
float32 on the CPU; every JAX result comes from one jitted function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import unet as TU
from eo_diffusion_torch.nn.primitives import GroupNorm32
from eo_diffusion_torch.ops import group_norm as TG
from eo_diffusion_torch.weights import randomize_parameters
from eo_diffusion_tpu.ops import group_norm as JG
from torch_parity import one_torch_thread, rel_err  # noqa: F401

# f32: max |port - jax| / max |jax|
REL_TOL = 1e-5

# name -> (channels, groups, act, film); N 2, 5 x 6 spatial
CASES = {
    "c64_none": (64, 32, "none", False),
    "c64_silu": (64, 32, "silu", False),
    "c24_g24_silu": (24, 24, "silu", False),
    "c24_g24_none": (24, 24, "none", False),
    "c64_film_silu": (64, 32, "silu", True),
}


def _inputs(name):
    c = CASES[name][0]
    rng = np.random.default_rng(len(name) * 100 + c)
    f = lambda *shape, loc=0.0, scale=1.0: (loc + scale * rng.normal(size=shape)).astype(
        np.float32)
    return {"x": f(2, 5, 6, c, loc=0.5, scale=2.0), "gamma": f(2, c, loc=1.0, scale=0.1),
            "beta": f(2, c, scale=0.1), "w": f(c, loc=1.0, scale=0.1), "b": f(c, scale=0.1),
            "s": f(2, c, scale=0.2), "t": f(2, c, scale=0.2), "dy": f(2, 5, 6, c)}


def _jax_case(name, d):
    """Forward (reference and Pallas interpret) and the vjp of the reference
    for one case; the FiLM case composes GN -> *(1+s)+t -> SiLU unfused."""
    _, groups, act, film = CASES[name]
    if film:
        n = d["x"].shape[0]
        w, b = (jnp.broadcast_to(v[None], (n, v.shape[0])) for v in (d["w"], d["b"]))

        def f(x, w, b):
            h = JG.group_norm_reference(x, w, b, groups)
            h = h * (1 + d["s"][:, None, None]) + d["t"][:, None, None]
            return h * jax.nn.sigmoid(h)

        y, vjp = jax.vjp(f, d["x"], w, b)
        dx, dw, db = vjp(d["dy"])
        return {"y": y, "dx": dx, "dw": dw.sum(0), "db": db.sum(0)}
    ref = lambda x, ga, be: JG.group_norm_reference(x, ga, be, groups, act=act)
    y, vjp = jax.vjp(ref, d["x"], d["gamma"], d["beta"])
    dx, dgamma, dbeta = vjp(d["dy"])
    pallas = JG._gn_pallas(d["x"], d["gamma"], d["beta"], groups, 1e-5, act, interpret=True)
    return {"y": y, "pallas": pallas, "dx": dx, "dgamma": dgamma, "dbeta": dbeta}


@pytest.fixture(scope="module")
def jax_results():
    """Every case's JAX side through one jit: one compile for the file."""
    inputs = {name: _inputs(name) for name in CASES}
    out = jax.jit(lambda ins: {k: _jax_case(k, v) for k, v in ins.items()})(
        jax.tree.map(jnp.asarray, inputs))
    return inputs, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("name", sorted(k for k in CASES if not CASES[k][3]))
def test_forward_matches_reference_and_pallas(jax_results, name):
    inputs, res = jax_results
    _, groups, act, _ = CASES[name]
    d, r = inputs[name], res[name]
    x, ga, be = (torch.from_numpy(d[k]) for k in ("x", "gamma", "beta"))
    out = TG.group_norm_reference(x, ga, be, groups, act=act)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert rel_err(out, r["y"]) <= REL_TOL
    assert rel_err(out, r["pallas"]) <= REL_TOL
    # the autograd path on a CPU tensor computes the same values
    assert rel_err(TG.fused_group_norm(x, ga, be, groups, act=act), r["y"]) <= REL_TOL


@pytest.mark.parametrize("name", sorted(k for k in CASES if not CASES[k][3]))
def test_gradients_match_jax_vjp(jax_results, name):
    """fused_group_norm's autograd (GroupNormFn with the plain backward on
    the CPU) against jax.vjp of group_norm_reference: dx, dgamma, dbeta."""
    inputs, res = jax_results
    _, groups, act, _ = CASES[name]
    d, r = inputs[name], res[name]
    x, ga, be = (torch.from_numpy(d[k]).requires_grad_() for k in ("x", "gamma", "beta"))
    y = TG.fused_group_norm(x, ga, be, groups, act=act)
    assert type(y.grad_fn).__name__ == "GroupNormFnBackward"
    grads = torch.autograd.grad(y, (x, ga, be), torch.from_numpy(d["dy"]))
    for got, key in zip(grads, ("dx", "dgamma", "dbeta")):
        assert rel_err(got, r[key]) <= REL_TOL, key


def test_film_through_the_module_matches_composition(jax_results):
    """GroupNorm32 with a FiLM scale-shift and SiLU folded in (per-sample
    gamma = w(1+s), beta = b(1+s)+t) against the unfused JAX composition,
    forward and gradients of x, weight and bias."""
    inputs, res = jax_results
    d, r = inputs["c64_film_silu"], res["c64_film_silu"]
    mod = GroupNorm32(64)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(d["w"]))
        mod.bias.copy_(torch.from_numpy(d["b"]))
    x = torch.from_numpy(d["x"]).requires_grad_()
    y = mod(x, act="silu", scale=torch.from_numpy(d["s"]), shift=torch.from_numpy(d["t"]))
    assert rel_err(y, r["y"]) <= REL_TOL
    grads = torch.autograd.grad(y, (x, mod.weight, mod.bias), torch.from_numpy(d["dy"]))
    for got, key in zip(grads, ("dx", "dw", "db")):
        assert rel_err(got, r[key]) <= REL_TOL, key


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("loc", [0.0, 100.0])  # mean 100, std 1: the cancellation case
def test_plain_backward_matches_autograd_of_plain_forward(act, loc):
    rng = np.random.default_rng(int(loc) + len(act))
    x = torch.from_numpy((loc + rng.normal(size=(2, 7, 3, 48))).astype(np.float32))
    ga = torch.from_numpy((1 + 0.1 * rng.normal(size=(2, 48))).astype(np.float32))
    be = torch.from_numpy((0.1 * rng.normal(size=(2, 48))).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(2, 7, 3, 48)).astype(np.float32))
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, ga, be))
    want = torch.autograd.grad(TG.group_norm_reference(xs, gs, bs, 16, act=act), (xs, gs, bs), dy)
    mean, rstd = TG._stats(x, 16, 1e-5)
    got = TG.group_norm_backward_reference(x, ga, be, mean, rstd, dy, 16, act)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert rel_err(a, b.numpy()) <= REL_TOL


def test_function_saves_stats_not_outputs_and_nothing_without_grad():
    x = torch.randn(2, 4, 4, 32)
    ga, be = torch.ones(32), torch.zeros(32)
    with torch.inference_mode():
        y = TG.fused_group_norm(x, ga, be, 8, act="silu")
    assert y.grad_fn is None
    y = TG.fused_group_norm(x.requires_grad_(), ga, be, 8, act="silu")
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[0].data_ptr() == x.data_ptr()  # x itself, no copy
    assert [tuple(t.shape) for t in saved[3:]] == [(2, 8), (2, 8)]
    assert all(t.dtype == torch.float32 for t in saved)
    # bf16 in, bf16 out, float32 statistics
    assert TG.fused_group_norm(x.detach().bfloat16(), ga, be, 8).dtype == torch.bfloat16


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_arguments():
    x, p, s = torch.zeros(1, 4, 8), torch.zeros(1, 8), torch.zeros(1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        TG.group_norm_fwd_cuda(x, p, p, 2)
    with pytest.raises(ValueError, match="CUDA"):
        TG.group_norm_bwd_cuda(x, p, p, s, s, x, 2)
    assert TG.group_norm_fwd_cuda.launches == TG.group_norm_bwd_cuda.launches == 0
    with pytest.raises(ValueError, match="impl"):
        TG.fused_group_norm(x, p[0], p[0], 2, impl="pallas")
    with pytest.raises(ValueError, match="act"):
        TG.fused_group_norm(x, p[0], p[0], 2, act="gelu")


def _norm_sites(cfg):
    plan = TU.build_unet_plan(cfg)
    kinds = [s.kind for blk in (*plan.input_blocks, plan.middle_block, *plan.output_blocks)
             for s in blk]
    return 2 * kinds.count("res") + kinds.count("attn") + 1


def test_unet_norm_sites_and_set_impl():
    """The clouds UNet at 256 px runs 56 GroupNorms a forward (2 a ResBlock,
    1 an attention block, the output norm), each a GroupNorm32 module; on the
    CPU the plain and auto paths give the same bits, and set_impl reaches
    every norm and attention block."""
    assert _norm_sites(TU.unet_clouds(256)) == 56
    cfg = TU.UNetConfig(image_size=8, in_channels=3, model_channels=16, out_channels=3,
                        num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                        num_heads=2, use_scale_shift_norm=True)
    model = randomize_parameters(TU.UNet(cfg), seed=0).eval()
    norms = [m for m in model.modules() if isinstance(m, GroupNorm32)]
    assert len(norms) == _norm_sites(cfg) and all(m.impl == "auto" for m in norms)
    x, t = torch.randn(2, 8, 8, 3), torch.tensor([1, 5])
    with torch.no_grad():
        auto = model(x, t)
        plain = model.set_impl(attn="plain", norm="plain")(x, t)
    assert all(m.impl == "plain" for m in norms)
    assert all(m.attn_impl == "plain" for m in model.modules() if isinstance(m, TU.AttentionBlock))
    assert auto.abs().max() > 0 and torch.equal(auto, plain)
    with pytest.raises(ValueError):
        model.set_impl(norm="pallas")
