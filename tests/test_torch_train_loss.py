"""The port's training loss against eo_diffusion_tpu (f32, CPU): every
objective and reweighting, on one UNet built in both packages.

The JAX side draws its own timesteps (``randint(split(rng, 3)[0], ...)``,
gaussian.py:439-441); the test recovers them and feeds the port through
``t=``. The noise is fixed on both sides through ``noise=``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from torch_parity import configs, one_torch_thread, port_model, random_params  # noqa: F401

T = 10
UNET = dict(image_size=8, in_channels=6, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=4)
VARIANTS = {
    "eps": dict(objective="eps"),
    "x0": dict(objective="x0"),
    "v": dict(objective="v"),
    "v-zero-terminal-snr": dict(objective="v", zero_terminal_snr=True),
    "eps-p2": dict(objective="eps", p2_loss_weight_gamma=0.5, p2_loss_weight_k=1.0),
    "eps-min-snr": dict(objective="eps", min_snr_gamma=5.0),
    "x0-min-snr": dict(objective="x0", min_snr_gamma=5.0),
    "v-min-snr": dict(objective="v", min_snr_gamma=5.0),
    "eps-elbo": dict(objective="eps", elbo_weight=0.1),
    "v-p2-min-snr-elbo": dict(objective="v", p2_loss_weight_gamma=1.0, min_snr_gamma=3.0,
                              elbo_weight=0.05),
}


@pytest.fixture(scope="module")
def twin():
    """One concat-conditioned UNet in both packages, a batch, and the JAX
    side's own timestep draw."""
    jcfg, tcfg = configs(**UNET)
    jmodel, params = random_params(jcfg, seed=21, cond_channels=3)
    tmodel = port_model(tcfg, params)
    jfn = jax.jit(lambda x, t, c, y: jmodel.apply(params, x, t, cond=c, y=y))
    tfn = lambda x, t, c, y: tmodel(x, t, cond=c, y=y)
    rng = np.random.default_rng(22)
    x0, cond, noise = (rng.normal(size=(4, 8, 8, 3)).astype(np.float32) for _ in range(3))
    key = jax.random.PRNGKey(5)
    t = np.asarray(jax.random.randint(jax.random.split(key, 3)[0], (4,), 0, T))
    return jfn, tfn, key, x0, cond, noise, t


@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_loss_matches_jax(twin, name):
    jfn, tfn, key, x0, cond, noise, t = twin
    kw = dict(timesteps=T, image_size=8, in_channels=3, cond_type="concat", **VARIANTS[name])
    jd, td = JGD.create(**kw), TGD.create(**kw)
    want = float(jd.train_loss(jfn, key, jnp.asarray(x0), cond=jnp.asarray(cond),
                               noise=jnp.asarray(noise)))
    tx0, tcond, tnoise, tt = map(torch.from_numpy, (x0, cond, noise, t.astype(np.int64)))
    with torch.no_grad():
        got = td.train_loss(tfn, tx0, cond=tcond, noise=tnoise, t=tt)
        assert got.dtype == torch.float32 and got.ndim == 0
        assert abs(got.item() - want) <= 1e-5 * abs(want)  # loss rel-err <= 1e-5

        # the decomposition: training_tuple and training_weight equal JAX's
        # (allclose at f32 rounding), and mean(w * (pred - target)^2) is the loss
        jx_t, jt, jtarget = jd.training_tuple(key, jnp.asarray(x0), jnp.asarray(noise))
        x_t, t2, target = td.training_tuple(tx0, noise=tnoise, t=tt)
        np.testing.assert_array_equal(t2.numpy(), np.asarray(jt))
        np.testing.assert_allclose(x_t.numpy(), np.asarray(jx_t), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), rtol=1e-6, atol=1e-6)
        jw, w = jd.training_weight(jt), td.training_weight(t2)
        assert (jw is None) == (w is None)
        err = (tfn(x_t, t2, tcond, None) - target) ** 2
        if w is not None:
            np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5)
            err = err * w[:, None, None, None]
        assert abs(err.mean().item() - got.item()) <= 1e-5 * abs(got.item())


def test_generator_draws_and_the_gradient_flows(twin):
    """Without t= and noise= the draws come from the explicit generator (the
    same seed gives the same loss), and the loss backpropagates into the UNet."""
    _, tfn, _, x0, cond, _, _ = twin
    td = TGD.create(timesteps=T, image_size=8, in_channels=3, cond_type="concat")
    tx0, tcond = torch.from_numpy(x0), torch.from_numpy(cond)
    losses = [td.train_loss(tfn, tx0, generator=torch.Generator().manual_seed(s), cond=tcond)
              for s in (0, 0, 1)]
    assert losses[0].item() == losses[1].item() != losses[2].item()
    model = tfn.__closure__[0].cell_contents
    model.zero_grad()
    losses[0].backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(g.abs().max() > 0 for g in grads)
    model.zero_grad()


def test_create_keeps_the_jax_assertions():
    with pytest.raises(AssertionError, match="zero_terminal_snr"):
        TGD.create(timesteps=T, zero_terminal_snr=True, objective="eps")
    assert TGD.create(timesteps=T, self_condition=True).self_condition
