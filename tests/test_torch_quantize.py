"""The port's int8 serving paths against the JAX package's on the CPU:
weight-only int8 storage (``utils/quantize.py``: int8 leaves bit for bit,
scales to 1e-7, the same packed bytes) and the W8A8 ``Dense`` route
(``nn.primitives.int8_dense_compute``: ``_Int8Dense`` at a routed shape and
below each threshold, and a DiT forward inside both contexts). One jitted
JAX function: the DiT forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.nn import primitives as TP
from eo_diffusion_torch.utils import quantize as TQ
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params, model_layout
from eo_diffusion_tpu.models import dit as JD
from eo_diffusion_tpu.nn import primitives as JP
from eo_diffusion_tpu.utils import quantize as JQ
from torch_parity import one_torch_thread, random_dit_params, rel_err  # noqa: F401

# tiny-dit widened so the W8A8 route engages (hidden 256 >= _INT8_MIN_DIM), at
# batch 64: 64 x 16 tokens = 1024 rows, the route's row threshold
KW = dict(image_size=16, in_channels=3, out_channels=3, patch_size=4, hidden_size=256,
          depth=2, num_heads=4, num_classes=None)
SCALE_TOL = 1e-7
DENSE_TOL = 1e-6
# a whole W8A8 forward: the float forwards agree to ~1e-6, and an activation
# that close to a half-way point rounds to the other int8 value, moving its
# token's row (on the CPU it reads 7.6e-4, against the route's own effect of
# 5.1e-3); with JAX's inputs fed to the routed products, the forward bar
W8A8_FORWARD_TOL = 2e-3
W8A8_REPLAY_TOL = 1e-5


@pytest.fixture(scope="module")
def dit():
    """The JAX DiT's seeded params and the port's DiT carrying them."""
    jcfg, tcfg = JD.DiTConfig(**KW), TD.DiTConfig(**KW)
    jmodel, params = random_dit_params(jcfg, seed=3)
    model = TD.DiT(tcfg)
    model.load_state_dict(dit_state_dict_from_jax_params(params, tcfg), strict=True)
    return jmodel, params, model.eval()


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_quantize_tree_matches_jax_leaf_for_leaf(dit):
    _, params, model = dit
    jq, js = JQ.quantize_tree(jax.tree.map(jnp.asarray, params))
    tq, ts = TQ.quantize_tree(dict(model.named_parameters()), TQ.flax_views(model))
    p = params["params"] if "params" in params else params
    jq_p, js_p = (t["params"] if "params" in t else t for t in (jq, js))
    n_int8 = 0
    for fpath, tname, fwd, _ in model_layout(model):
        q, s = _leaf(jq_p, fpath), _leaf(js_p, fpath)
        if q.dtype == np.int8:
            n_int8 += 1
            assert tq[tname].dtype == torch.int8
            np.testing.assert_array_equal(tq[tname].numpy(), fwd(q))  # bit for bit
            want = fwd(s).astype(np.float32)
            got = ts[tname].numpy()
            assert got.shape == want.shape, tname
            assert np.max(np.abs(got - want) / np.abs(want)) <= SCALE_TOL, tname
        else:  # passes through, unit scale
            np.testing.assert_array_equal(tq[tname].numpy(), fwd(_leaf(p, fpath)))
            assert float(ts[tname]) == float(s) == 1.0
    assert n_int8 >= 10
    assert TQ.quantized_bytes(tq) == JQ.quantized_bytes(jq)


def test_dequantize_tree_matches_jax(dit):
    _, params, model = dit
    jq, js = JQ.quantize_tree(jax.tree.map(jnp.asarray, params))
    jd = JQ.dequantize_tree(jq, js)
    jd_p = jd["params"] if "params" in jd else jd
    tq, ts = TQ.quantize_tree(dict(model.named_parameters()), TQ.flax_views(model))
    td = TQ.dequantize_tree(tq, ts)
    for fpath, tname, fwd, _ in model_layout(model):
        want = fwd(_leaf(jd_p, fpath))
        assert td[tname].dtype == torch.float32
        assert rel_err(td[tname], want) <= SCALE_TOL, tname
    # within a quantization step of the float weights
    w = dict(model.named_parameters())["block_0.qkv.weight"].detach()
    assert 0 < float((td["block_0.qkv.weight"] - w).abs().max()) <= float(w.abs().max()) / 127


@pytest.mark.parametrize("rows,fin,fout", [(1024, 256, 256), (1000, 256, 256),
                                            (1024, 128, 256), (1024, 256, 128)])
def test_w8a8_dense_matches_jax_int8_dense(rows, fin, fout):
    """The routed shape, then one shape below each threshold (rows, in,
    out), where both take the plain product."""
    rng = np.random.default_rng(rows + fin + fout)
    x = rng.normal(size=(rows // 16, 16, fin)).astype(np.float32)
    k = (rng.normal(size=(fin, fout)) / np.sqrt(fin)).astype(np.float32)
    b = rng.normal(size=(fout,)).astype(np.float32) * 0.05
    want = np.asarray(JP._Int8Dense(features=fout).apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}, jnp.asarray(x)))
    layer = TP.Dense(fin, fout)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(k.T))
        layer.bias.copy_(torch.from_numpy(b))
        plain = layer(torch.from_numpy(x))
        with TP.int8_dense_compute():
            got = layer(torch.from_numpy(x))
    assert not TP._INT8_DENSE.get()  # the context restores the route
    assert rel_err(got, want) <= DENSE_TOL
    routed = rows >= 1024 and min(fin, fout) >= 256
    assert torch.equal(got, plain) != routed  # only the routed shape quantizes
    if routed:
        assert 1e-4 < rel_err(got, plain.numpy()) < 0.05


def test_zero_dense_and_zero_projection_stay_plain():
    """JAX keeps ZeroDense out of the route; the port keeps ZeroDense and the
    zero PointwiseConv1d (the UNet's proj_out) out, and routes the qkv one."""
    x = torch.randn(1100, 256)
    for layer, routed in ((TP.ZeroDense(256, 256), False),
                          (TP.PointwiseConv1d(256, 256, zero=True), False),
                          (TP.PointwiseConv1d(256, 768), True)):
        torch.nn.init.normal_(layer.weight, std=0.05)
        with torch.no_grad():
            plain = layer(x)
            with TP.int8_dense_compute():
                got = layer(x)
        assert torch.equal(got, plain) != routed


def test_dit_forward_under_w8a8_matches_jax(dit, monkeypatch):
    """Every routed product of a DiT forward inside the context equals the
    JAX package's ``_Int8Dense`` on the same input (``DENSE_TOL``), and the
    whole forward stays within ``W8A8_FORWARD_TOL`` (rel L2) of JAX's inside
    its context: far inside the route's own effect on the output. The gap is
    the activations' rounding: fed JAX's inputs to its routed products, the
    port's forward holds to ``W8A8_REPLAY_TOL``; at the first routed product
    the two inputs part by a small fraction of a quantization step, and each
    int8 value that differs there lies that close to a half-way point."""
    from flax import linen as nn

    jmodel, params, model = dit
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 16, 16, 3)).astype(np.float32)
    t = rng.uniform(0, 999, size=(64,)).astype(np.float32)
    base = JP._Int8Dense

    class Recorded(base):  # JAX's route, its input sown for the comparison
        @nn.compact
        def __call__(self, h):
            self.sow("intermediates", "x", h)
            return base.__call__(self, h)

    monkeypatch.setattr(JP, "_Int8Dense", Recorded)
    with JP.int8_dense_compute():  # JAX routes while jit traces
        want, sown = jax.jit(lambda p, x, t: jmodel.apply(p, x, t, mutable=["intermediates"]))(
            params, jnp.asarray(x), jnp.asarray(t))
    monkeypatch.setattr(JP, "_Int8Dense", base)
    want = np.asarray(want)
    jax_in = [np.array(sown["intermediates"][f"block_{i}"][name]["x"][0])
              for i in range(KW["depth"]) for name in ("qkv", "proj_out", "mlp_in", "mlp_out")]
    calls, real = [], TP.int8_linear
    monkeypatch.setattr(TP, "int8_linear", lambda *a: calls.append(a) or real(*a))
    with torch.no_grad(), TP.int8_dense_compute():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    routed = [a for a in calls
              if a[0].numel() // a[0].shape[-1] >= 1024 and min(a[1].shape) >= 256]
    assert len(routed) == 4 * KW["depth"]  # qkv, proj_out, mlp_in, mlp_out a block
    for (xin, w, b, dt), xj in zip(routed, jax_in):
        assert xin.shape == xj.shape
        with torch.no_grad():
            mine = real(xin, w, b, dt)
        theirs = JP._Int8Dense(features=w.shape[0]).apply(
            {"params": {"kernel": jnp.asarray(w.detach().numpy().T),
                        "bias": jnp.asarray(b.detach().numpy())}}, jnp.asarray(xin.numpy()))
        assert rel_err(mine, np.asarray(theirs)) <= DENSE_TOL
    with torch.no_grad():
        plain = model(torch.from_numpy(x), torch.from_numpy(t))
    effect = rel_l2(plain, want)
    assert effect > 1e-3  # the route changed the numbers
    assert rel_l2(got, want) <= W8A8_FORWARD_TOL < effect

    # the first routed product: the float forwards feed it inputs a small
    # fraction of a step apart; an int8 value differs only where its input
    # lies within that of a half-way point (this input: 2 of 262144, within
    # 5.7e-5 of a step, which the later products carry on)
    u_t, u_j = (h / (np.abs(h).max() / np.float32(127.0))
                for h in (routed[0][0].numpy(), jax_in[0]))
    gap = float(np.abs(u_t - u_j).max())
    flipped = np.round(u_t) != np.round(u_j)
    assert gap < 1e-3
    assert np.all(np.abs(np.abs(u_t - np.floor(u_t)) - 0.5)[flipped] <= gap)
    # JAX's inputs to the routed products, the port's everything else
    replay = iter(jax_in)
    monkeypatch.setattr(TP, "int8_linear", lambda xin, w, b, dt: real(
        torch.from_numpy(next(replay)) if xin.numel() // xin.shape[-1] >= 1024
        and min(w.shape) >= 256 else xin, w, b, dt))
    with torch.no_grad(), TP.int8_dense_compute():
        replayed = model(torch.from_numpy(x), torch.from_numpy(t))
    assert next(replay, None) is None
    assert rel_l2(replayed, want) <= W8A8_REPLAY_TOL


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))
