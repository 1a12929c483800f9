"""The port's training checkpoints (torch.save in place of Orbax): round trip
of the whole train state, exact resume, retention, and the sampling loader."""

import os

import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
from eo_diffusion_torch.models.unet import UNet, UNetConfig
from eo_diffusion_torch.train import checkpoint as C
from eo_diffusion_torch.train.trainer import Trainer, TrainerConfig
from eo_diffusion_torch.weights import load_reference_checkpoint, randomize_parameters
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

T, BS = 10, 4
UCFG = UNetConfig(image_size=8, in_channels=3, model_channels=32, out_channels=3,
                  num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                  num_heads=4)


def _trainer(**kw):
    cfg = TrainerConfig(lr=2e-3, batch_size=BS, epochs=2, timesteps=T, model_ema_steps=2,
                        seed=1, **kw)
    tr = Trainer(cfg, randomize_parameters(UNet(UCFG), seed=2),
                 GaussianDiffusion.create(timesteps=T, image_size=8), 4, device="cpu")
    return tr, tr.init()


def _batch(i):
    rng = np.random.default_rng(100 + i)
    return {"image": rng.uniform(-1, 1, (BS, 8, 8, 3)).astype(np.float32)}


def _flat(state):
    """Every tensor and counter of a train state, for comparison."""
    opt = [v for p in state.params for k, v in sorted(state.optimizer.state[p].items())]
    acc = state.acc_grads or []
    return ([*state.params, *state.ema_params, *opt, *acc],
            (state.step, state.opt_step, state.mini_step, state.notfinite_count,
             state.total_notfinite, state.optimizer.param_groups[0]["lr"]))


def test_round_trip_of_the_whole_state(tmp_path):
    """Saved mid-accumulation with a skipped update behind it: parameters,
    EMA, Adam's moments and step, the gradient accumulator and the counters
    all come back."""
    tr, state = _trainer(grad_accum=2, skip_nonfinite=True)
    for i in range(3):
        state, _ = tr.step(state, _batch(i))
    state, m = tr.step(state, {"image": np.full((BS, 8, 8, 3), np.nan, np.float32)})
    assert m["notfinite_count"] == 1 and state.mini_step == 1 and state.acc_grads is not None
    path = C.save_checkpoint(str(tmp_path), state.state_dict(), step=state.step)
    assert os.path.basename(path) == "steps_00000004" and C.latest_step(str(tmp_path)) == 4

    tr2, fresh = _trainer(grad_accum=2, skip_nonfinite=True)
    restored = C.restore_checkpoint(path, fresh)
    (want_t, want_c), (got_t, got_c) = _flat(state), _flat(restored)
    assert got_c == want_c and len(got_t) == len(want_t)
    assert all(torch.equal(a, b) for a, b in zip(got_t, want_t))
    raw = C.restore_checkpoint(path)
    assert set(raw) >= {"model", "model_ema", "opt_state", "step"}
    model_sd, ema_sd = C.restore_params(path)
    assert torch.equal(model_sd["out.2.weight"], state.model.state_dict()["out.2.weight"])
    assert not torch.equal(model_sd["out.2.weight"], ema_sd["out.2.weight"])


def test_resume_gives_the_uninterrupted_run(tmp_path):
    """3 steps, save, restore into a new trainer, 3 more: the same losses, LR
    and EMA cadence, and the same final state, as 6 steps in one go. Like the
    JAX trainer's key, the generator's state is not part of a checkpoint, so
    the batches carry their timesteps and noise."""
    def batch(i):
        rng = np.random.default_rng(200 + i)
        return dict(_batch(i), t=rng.integers(0, T, (BS,)),
                    noise=rng.normal(size=(BS, 8, 8, 3)).astype(np.float32))

    tr, state = _trainer()
    whole = []
    for i in range(6):
        state, m = tr.step(state, batch(i))
        whole.append((float(m["loss"]), tr.current_lr(state.step - 1)))

    tr1, s1 = _trainer()
    for i in range(3):
        s1, _ = tr1.step(s1, batch(i))
    path = C.save_checkpoint(str(tmp_path), s1.state_dict(), step=s1.step)
    tr2, s2 = _trainer()
    s2 = C.restore_checkpoint(path, s2)
    assert s2.step == 3
    resumed = []
    for i in range(3, 6):
        s2, m = tr2.step(s2, batch(i))
        resumed.append((float(m["loss"]), tr2.current_lr(s2.step - 1)))
    assert resumed == whole[3:]
    for a, b in zip(_flat(s2)[0], _flat(state)[0]):
        assert torch.equal(a, b)
    assert _flat(s2)[1] == _flat(state)[1]


def test_manager_keeps_the_newest(tmp_path):
    _, state = _trainer()
    mgr = C.CheckpointManager(str(tmp_path), max_to_keep=2)
    C.save_checkpoint(str(tmp_path), state.state_dict(), name="best")
    for step in (1, 2, 3, 4):
        state.step = step
        mgr.save(step, state.state_dict())
    assert sorted(os.listdir(tmp_path)) == ["best", "steps_00000003", "steps_00000004"]
    assert C.best_dir(str(tmp_path)) == os.path.join(str(tmp_path), "best")
    assert mgr.restore_latest()["step"] == 4
    assert C.CheckpointManager(str(tmp_path / "none")).restore_latest() is None
    assert C.latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("use_ema", [True, False])
def test_sampling_loader_reads_a_training_checkpoint(tmp_path, use_ema):
    tr, state = _trainer()
    for i in range(2):
        state, _ = tr.step(state, _batch(i))
    path = C.save_checkpoint(str(tmp_path), state.state_dict(), step=2)
    sd = load_reference_checkpoint(path, UCFG, use_ema=use_ema)
    want = (state.ema_model if use_ema else state.model).state_dict()
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    UNet(UCFG).load_state_dict(sd, strict=True)
