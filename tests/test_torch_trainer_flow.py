"""The port's Trainer with rectified flow on the ``tiny-flow`` preset's UNet
(concat conditioning) against the JAX Trainer, f32 on the CPU: a few steps
from the same state on the same batches. The flow times are recovered from
the JAX step's key (``uniform(split(loss_rng)[0], (n,))``, flow.py:64-91),
the noise rides the batch; one jitted JAX step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion.flow import FlowMatching as TFM
from eo_diffusion_torch.models.unet import UNet
from eo_diffusion_torch.train.trainer import Trainer as TTrainer
from eo_diffusion_torch.train.trainer import TrainerConfig as TConfig
from eo_diffusion_torch.weights import load_jax_train_state, state_dict_from_jax_params
from eo_diffusion_tpu.diffusion.flow import FlowMatching as JFM
from eo_diffusion_tpu.train.trainer import Trainer as JTrainer
from eo_diffusion_tpu.train.trainer import TrainerConfig as JConfig
from eo_diffusion_tpu.train.trainer import TrainState as JState
from torch_parity import configs, one_torch_thread, random_params, rel_l2, trainer_steps  # noqa: F401

BS, STEPS = 4, 3
UNET = dict(image_size=8, in_channels=6, model_channels=32, out_channels=3, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1,), num_heads=1)  # tiny-flow, one level
COMMON = dict(lr=2e-3, batch_size=BS, epochs=2, model_ema_steps=1, seed=6, cond_type="concat",
              warmup_epochs=0, preview_sampler="flow", preview_steps=3)
FLOW = dict(image_size=8, in_channels=3, cond_type="concat")


@pytest.fixture(scope="module")
def runs():
    from eo_diffusion_tpu.parallel.mesh import make_mesh

    jcfg, tcfg = configs(**UNET)
    jmodel, params = random_params(jcfg, seed=61, cond_channels=3)
    jtr = JTrainer(JConfig(**COMMON), jmodel, JFM.create(**FLOW), 4,
                   mesh=make_mesh(jax.devices()[:1]))
    jstate = jtr.shard_state(JState.create(jax.tree.map(jnp.asarray, params), jtr.tx))
    rng = np.random.default_rng(62)
    batches = [{"image": rng.uniform(-1, 1, (BS, 8, 8, 3)).astype(np.float32),
                "noise": rng.normal(size=(BS, 8, 8, 3)).astype(np.float32),
                "cond": rng.uniform(-1, 1, (BS, 8, 8, 3)).astype(np.float32)}
               for _ in range(STEPS)]
    ttr = TTrainer(TConfig(**COMMON), UNet(tcfg), TFM.create(**FLOW), 4, device="cpu")
    tstate = load_jax_train_state(ttr.init(), tcfg, params, params)
    draw_t = lambda k: jax.random.uniform(jax.random.split(k)[0], (BS,), jnp.float32)
    jout, tout, jstate, tstate = trainer_steps(jtr, jstate, ttr, tstate, batches,
                                               COMMON["seed"], draw_t)
    return dict(jout=jout, tout=tout, jstate=jstate, tstate=tstate, tcfg=tcfg, ttr=ttr,
                batches=batches, init=state_dict_from_jax_params(params, tcfg))


def test_losses_and_grad_norms_every_step(runs):
    for j, t in zip(runs["jout"], runs["tout"]):
        assert abs(t["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"]), (t, j)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=2e-4)


def test_final_parameters_and_ema(runs):
    tstate, jstate, tcfg, init = (runs[k] for k in ("tstate", "jstate", "tcfg", "init"))
    assert tstate.step == int(jstate.step) == STEPS
    named, ema = dict(tstate.model.named_parameters()), dict(tstate.ema_model.named_parameters())
    for got, tree in ((named, jstate.params), (ema, jstate.ema_params)):
        want = state_dict_from_jax_params(tree, tcfg)
        assert rel_l2([got[k] for k in want], [want[k] for k in want]) <= 1e-3
    assert rel_l2([named[k] for k in init], [init[k] for k in init]) > 1e-3


def test_flow_preview_integrates_the_ema_model(runs):
    """``preview_sampler="flow"``: FlowMatching.sample over the EMA weights,
    ``preview_steps`` Euler intervals from the seeded generator."""
    ttr, tstate, b = runs["ttr"], runs["tstate"], runs["batches"][0]
    cond = torch.from_numpy(b["cond"][:2])
    got = ttr.sample(tstate, seed=7, n=2, cond=cond)
    gen = torch.Generator().manual_seed(7)
    model = tstate.ema_model
    want = TFM.create(**FLOW).sample(lambda x, t, c, y: model(x, t, cond=c), 2, device="cpu",
                                     generator=gen, num_steps=3, cond=cond).x
    assert got.shape == (2, 8, 8, 3) and torch.equal(got, want)


def test_process_and_preview_sampler_must_agree():
    from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD

    model = UNet(configs(**dict(UNET, in_channels=3))[1])
    with pytest.raises(ValueError, match="flow needs flow"):
        TTrainer(TConfig(preview_sampler="ddim"), model, TFM.create(**FLOW), 4, device="cpu")
    with pytest.raises(ValueError, match="flow needs flow"):
        TTrainer(TConfig(preview_sampler="flow"), model, TGD.create(timesteps=10, image_size=8),
                 4, device="cpu")
