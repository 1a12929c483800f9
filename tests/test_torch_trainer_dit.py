"""The port's Trainer on the tiny DiT (the ``tiny-dit`` preset's backbone,
with concat conditioning and class labels) against the JAX Trainer, DDPM,
f32 on the CPU: a few steps from the same state on the same batches,
carried over by ``load_jax_train_state`` with a ``DiTConfig``. The
timesteps are recovered from the JAX step's key (as in
tests/test_torch_trainer.py); one jitted JAX step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.train.trainer import Trainer as TTrainer
from eo_diffusion_torch.train.trainer import TrainerConfig as TConfig
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params, load_jax_train_state
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from eo_diffusion_tpu.models import dit as JD
from eo_diffusion_tpu.train.trainer import Trainer as JTrainer
from eo_diffusion_tpu.train.trainer import TrainerConfig as JConfig
from eo_diffusion_tpu.train.trainer import TrainState as JState
from torch_parity import one_torch_thread, random_dit_params, rel_l2, trainer_steps  # noqa: F401

T, BS, STEPS, CLASSES = 20, 4, 3, 3
DIT = dict(image_size=16, in_channels=6, out_channels=3, patch_size=4, hidden_size=64, depth=2,
           num_heads=4, num_classes=CLASSES)  # tiny-dit, concat cond and labels
COMMON = dict(lr=2e-3, batch_size=BS, epochs=2, timesteps=T, model_ema_steps=1, seed=5,
              cond_type="concat", num_classes=CLASSES, warmup_epochs=0)
DIFFUSION = dict(timesteps=T, image_size=16, in_channels=3, cond_type="concat")


@pytest.fixture(scope="module")
def runs():
    from eo_diffusion_tpu.parallel.mesh import make_mesh

    jcfg, tcfg = JD.DiTConfig(**DIT), TD.DiTConfig(**DIT)
    jmodel, params = random_dit_params(jcfg, seed=51, cond_channels=3)
    jtr = JTrainer(JConfig(**COMMON), jmodel, JGD.create(**DIFFUSION), 4,
                   mesh=make_mesh(jax.devices()[:1]))
    jstate = jtr.shard_state(JState.create(jax.tree.map(jnp.asarray, params), jtr.tx))
    rng = np.random.default_rng(52)
    batches = [{"image": rng.uniform(-1, 1, (BS, 16, 16, 3)).astype(np.float32),
                "noise": rng.normal(size=(BS, 16, 16, 3)).astype(np.float32),
                "cond": rng.uniform(-1, 1, (BS, 16, 16, 3)).astype(np.float32),
                "label": rng.integers(0, CLASSES, (BS,)).astype(np.int32)}
               for _ in range(STEPS)]
    ttr = TTrainer(TConfig(**COMMON), TD.DiT(tcfg), TGD.create(**DIFFUSION), 4, device="cpu")
    tstate = load_jax_train_state(ttr.init(), tcfg, params, params)
    draw_t = lambda k: jax.random.randint(jax.random.split(k, 3)[0], (BS,), 0, T)
    jout, tout, jstate, tstate = trainer_steps(jtr, jstate, ttr, tstate, batches,
                                               COMMON["seed"], draw_t)
    return dict(jout=jout, tout=tout, jstate=jstate, tstate=tstate, tcfg=tcfg,
                init=dit_state_dict_from_jax_params(params, tcfg))


def test_losses_and_grad_norms_every_step(runs):
    for j, t in zip(runs["jout"], runs["tout"]):
        assert abs(t["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"]), (t, j)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=2e-4)


def test_final_parameters_and_ema(runs):
    """A global relative L2 over all leaves (Adam's sign flips on near-zero
    gradients; tests/test_torch_trainer.py's argument and bar)."""
    tstate, jstate, tcfg, init = (runs[k] for k in ("tstate", "jstate", "tcfg", "init"))
    assert tstate.step == int(jstate.step) == STEPS
    named, ema = dict(tstate.model.named_parameters()), dict(tstate.ema_model.named_parameters())
    for got, tree in ((named, jstate.params), (ema, jstate.ema_params)):
        want = dit_state_dict_from_jax_params(tree, tcfg)
        assert rel_l2([got[k] for k in want], [want[k] for k in want]) <= 1e-3
    assert rel_l2([named[k] for k in init], [init[k] for k in init]) > 1e-3  # it moved
