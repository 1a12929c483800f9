"""The port's flow-matching training half (eo_diffusion_torch.diffusion.flow)
against eo_diffusion_tpu's, f32 on the CPU: the time draw, ``training_tuple``
and ``train_loss`` on a tiny UNet and a tiny DiT.

The JAX side draws t from its key: ``t_rng, n_rng = split(rng)`` then
``uniform(t_rng, (n,))`` or ``sigmoid(normal(t_rng, (n,)) * scale)``
(flow.py:64-91). The test recovers t and hands it to the port through
``t=``; the noise is fixed on both sides through ``noise=``. One jitted JAX
function computes both models' losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion.flow import FlowMatching as TFM
from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params
from eo_diffusion_tpu.diffusion.flow import FlowMatching as JFM
from eo_diffusion_tpu.models import dit as JD
from torch_parity import (configs, one_torch_thread, port_model, random_dit_params,  # noqa: F401
                          random_params)

REL_TOL = 1e-5  # tests/test_torch_train_loss.py's bar
N = 4
UNET = dict(image_size=8, in_channels=6, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4)
DIT = dict(image_size=8, in_channels=6, out_channels=3, patch_size=2, hidden_size=32, depth=2,
           num_heads=2, num_classes=3)
VARIANTS = {"uniform": {}, "logit_normal": dict(time_sampling="logit_normal"),
            "logit_normal-scale2": dict(time_sampling="logit_normal", logit_norm_scale=2.0)}
# the losses through the models (each a model trace in the one jitted function)
LOSS_VARIANTS = ("uniform", "logit_normal-scale2")
KEY = jax.random.PRNGKey(11)


def _jax_t(variant, key, n):
    """The t the JAX process draws from ``key`` (its training_tuple's
    split), recovered outside it."""
    t_rng = jax.random.split(key)[0]
    kw = VARIANTS[variant]
    if kw.get("time_sampling") == "logit_normal":
        return np.asarray(jax.nn.sigmoid(jax.random.normal(t_rng, (n,), jnp.float32)
                                         * kw.get("logit_norm_scale", 1.0)))
    return np.asarray(jax.random.uniform(t_rng, (n,), jnp.float32))


@pytest.fixture(scope="module")
def twin():
    """A concat-conditioned UNet and a class-conditional concat DiT in both
    packages, a batch, and every variant's JAX loss and training tuple from
    one jitted function."""
    jcfg, tcfg = configs(**UNET)
    junet, uparams = random_params(jcfg, seed=41, cond_channels=3)
    jdcfg, tdcfg = JD.DiTConfig(**DIT), TD.DiTConfig(**DIT)
    jdit, dparams = random_dit_params(jdcfg, seed=42, cond_channels=3)
    tdit = TD.DiT(tdcfg)
    tdit.load_state_dict(dit_state_dict_from_jax_params(dparams, tdcfg), strict=True)
    rng = np.random.default_rng(43)
    x0, cond, noise = (rng.normal(size=(N, 8, 8, 3)).astype(np.float32) for _ in range(3))
    y = np.array([0, 2, 1, 2], np.int32)

    @jax.jit
    def run(up, dp, x0, cond, y, noise):
        ufn = lambda x, t, c, yy: junet.apply(up, x, t, cond=c)
        dfn = lambda x, t, c, yy: jdit.apply(dp, x, t, cond=c, y=yy)
        out = {}
        for name, kw in VARIANTS.items():
            jf = JFM.create(image_size=8, in_channels=3, cond_type="concat", **kw)
            out[name] = {"tuple": jf.training_tuple(KEY, x0, noise)}
            if name in LOSS_VARIANTS:
                out[name]["unet"] = jf.train_loss(ufn, KEY, x0, cond=cond, noise=noise)
                out[name]["dit"] = jf.train_loss(dfn, KEY, x0, cond=cond, y=y, noise=noise)
        return out

    ref = jax.tree.map(np.asarray, run(uparams, dparams, *map(jnp.asarray,
                                                              (x0, cond, y, noise))))
    models = {"unet": port_model(tcfg, uparams), "dit": tdit.eval()}
    data = dict(x0=x0, cond=cond, y=y, noise=noise)
    return models, data, ref


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_training_tuple_matches_jax(twin, variant):
    _, d, ref = twin
    t = _jax_t(variant, KEY, N)
    jx, jt, jtarget = ref[variant]["tuple"]
    tf = TFM.create(image_size=8, in_channels=3, cond_type="concat", **VARIANTS[variant])
    x_t, t_model, target = tf.training_tuple(torch.from_numpy(d["x0"]),
                                             noise=torch.from_numpy(d["noise"]),
                                             t=torch.tensor(t))
    assert x_t.dtype == torch.float32 and target.dtype == torch.float32
    np.testing.assert_allclose(t_model.numpy(), jt, rtol=1e-6)  # t * time_scale
    np.testing.assert_allclose(x_t.numpy(), jx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(target.numpy(), jtarget, rtol=0, atol=1e-6)


@pytest.mark.parametrize("model", ["unet", "dit"])
@pytest.mark.parametrize("variant", LOSS_VARIANTS)
def test_train_loss_matches_jax(twin, model, variant):
    models, d, ref = twin
    want = float(ref[variant][model])
    tf = TFM.create(image_size=8, in_channels=3, cond_type="concat", **VARIANTS[variant])
    net = models[model]
    fn = lambda x, t, c, yy: net(x, t, cond=c, y=yy if model == "dit" else None)
    with torch.no_grad():
        got = tf.train_loss(fn, torch.from_numpy(d["x0"]), cond=torch.from_numpy(d["cond"]),
                            y=torch.from_numpy(d["y"]).long(),
                            noise=torch.from_numpy(d["noise"]),
                            t=torch.tensor(_jax_t(variant, KEY, N)))
    assert got.dtype == torch.float32 and want > 0.1
    assert abs(float(got) - want) <= REL_TOL * abs(want), (float(got), want)


def test_sample_t_draws_from_the_generator():
    """uniform: ``torch.rand``; logit-normal: the sigmoid of a scaled
    ``torch.randn``, both from the given generator, then eps after t."""
    x0 = torch.zeros(5, 4, 4, 3)
    for kw, draw in (({}, lambda g: torch.rand(5, generator=g)),
                     (dict(time_sampling="logit_normal", logit_norm_scale=1.5),
                      lambda g: torch.sigmoid(1.5 * torch.randn(5, generator=g)))):
        tf = TFM.create(image_size=4, in_channels=3, **kw)
        t = tf._sample_t(5, torch.Generator().manual_seed(3), "cpu")
        assert torch.equal(t, draw(torch.Generator().manual_seed(3)))
        assert ((t > 0) & (t < 1)).all()
        g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
        x_t, t_model, target = tf.training_tuple(x0 + 1.0, generator=g1)
        t_ref = draw(g2)
        eps = torch.randn(x0.shape, generator=g2)
        torch.testing.assert_close(t_model, t_ref * 1000.0)
        torch.testing.assert_close(target, eps - 1.0)
        torch.testing.assert_close(x_t, (1 - t_ref)[:, None, None, None] + t_ref[:, None, None,
                                                                              None] * eps)
    with pytest.raises(AssertionError):
        TFM.create(image_size=4, time_sampling="beta")._sample_t(2, None, "cpu")


def test_bf16_x0_keeps_its_dtype_and_an_f32_target():
    tf = TFM.create(image_size=4, in_channels=3)
    x0 = torch.randn(2, 4, 4, 3).bfloat16()
    x_t, t_model, target = tf.training_tuple(x0, generator=torch.Generator().manual_seed(0))
    assert x_t.dtype == torch.bfloat16 and target.dtype == t_model.dtype == torch.float32
    loss = tf.train_loss(lambda x, t, c, y: x.float() * 0, x0,
                         generator=torch.Generator().manual_seed(0))
    assert loss.dtype == torch.float32 and loss.ndim == 0
