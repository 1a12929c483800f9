"""The port's training CLI (python -m eo_diffusion_torch.cli.train) on the CPU:
the tiny concat preset, synthetic data, one short epoch."""

import importlib.util
import os
import signal

import numpy as np
import pytest
import torch

from eo_diffusion_torch.cli import inference, train
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

BASE = ["--preset", "tiny-cr", "--dataset", "synthetic", "--device", "cpu", "--batch_size", "4",
        "--steps_per_epoch", "4", "--n_samples", "4", "--preview_sampler", "ddim",
        "--preview_steps", "2", "--log_freq", "2", "--dir", "results/t"]


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the CLI writes logs/ and results/ under the cwd
    return tmp_path


def test_one_epoch_writes_checkpoints_and_previews_then_resumes(workdir, capsys):
    res = train.main(train.parse_args(BASE + ["--epochs", "1", "--sample_every", "4",
                                              "--save_every", "2"]))
    assert res["steps"] == 4 and len(res["losses"]) == 4 and res["preempted"] is None
    assert all(x == x and abs(x) < 10 for x in res["losses"])
    assert sorted(os.listdir(workdir / "logs" / "t")) == ["steps_00000002", "steps_00000004"]
    assert sorted(os.listdir(workdir / "results" / "t")) == [
        "steps_00000004.png", "steps_00000004_cond.png"]
    out = capsys.readouterr().out
    assert "Epoch[1/1],Step[0/4],loss:" in out and "done: 4 steps in" in out

    # --resume picks up the newest checkpoint and continues step, LR and EMA cadence
    res2 = train.main(train.parse_args(BASE + ["--epochs", "2", "--sample_every", "0",
                                               "--save_every", "0", "--resume"]))
    out = capsys.readouterr().out
    assert "auto-resume: found" in out and "resuming from step 4" in out
    assert "Epoch[2/2],Step[0/4]" in out and "Epoch[1/2]" not in out
    assert res2["steps"] == 8 and len(res2["losses"]) == 4
    assert res2["checkpoint"].endswith("steps_00000008") and res2["state"].opt_step == 8

    # the sampling CLI reads the training checkpoint (EMA weights first)
    args = inference.parse_args(["--preset", "tiny-cr", "--dataset", "synthetic", "--device",
                                 "cpu", "--sampler", "ddim", "--sampler_steps", "2",
                                 "--n_iter", "0", "--batch_size", "2", "--ckpt",
                                 res2["checkpoint"], "--outdir", str(workdir / "out")])
    x = torch.as_tensor(inference.main(args)["samples"])
    assert x.shape == (2, 8, 8, 3) and bool(torch.isfinite(x).all())


def test_best_checkpoint_follows_the_loss_from_the_reference_bar(workdir, monkeypatch):
    """A ``best`` checkpoint is written when the loss falls below 0.9 and then
    below its own best (train.py:100, :133-155)."""
    from eo_diffusion_torch.train import trainer as TR

    losses = iter([1.2, 0.95, 0.8, 0.85, 0.5, 0.7])
    real_step = TR.Trainer.step

    def step(self, state, batch):
        state, m = real_step(self, state, batch)
        return state, dict(m, loss=torch.tensor(next(losses)))

    monkeypatch.setattr(TR.Trainer, "step", step)
    saved = []
    from eo_diffusion_torch.train import checkpoint as C
    real_save = C.save_checkpoint
    monkeypatch.setattr(C, "save_checkpoint", lambda d, s, step=None, name=None: (
        saved.append((name, s["step"])), real_save(d, s, step=step, name=name))[1])
    train.main(train.parse_args(BASE + ["--epochs", "1", "--steps_per_epoch", "6",
                                        "--sample_every", "0", "--save_every", "0"]))
    assert saved == [("best", 3), ("best", 5), (None, 6)]


def test_sigterm_finishes_the_step_checkpoints_and_exits(workdir, monkeypatch, capsys):
    from eo_diffusion_torch.train import trainer as TR

    real_step = TR.Trainer.step

    def step(self, state, batch):
        out = real_step(self, state, batch)
        if out[0].step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(TR.Trainer, "step", step)
    before = signal.getsignal(signal.SIGTERM)
    res = train.main(train.parse_args(BASE + ["--epochs", "3", "--sample_every", "0",
                                              "--save_every", "0"]))
    assert res["preempted"] == signal.SIGTERM and res["steps"] == 2
    assert os.path.exists(workdir / "logs" / "t" / "steps_00000002")
    assert "rerun with --resume" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("flag,queue", [("--fsdp", 16), ("--optimizer=muon", 14),
                                        ("--config", 14),
                                        ("--tome_ratio", 13), ("--profile_dir", 17)])
def test_unported_flags_exit_naming_their_queue(flag, queue, capsys):
    with pytest.raises(SystemExit) as exc:
        train.parse_args(["--preset", "tiny", flag])
    assert exc.value.code != 0
    assert f"ROADMAP queue {queue}" in capsys.readouterr().err


def test_unported_presets_and_datasets_raise(workdir):
    from PIL import Image

    with pytest.raises(NotImplementedError, match="queue 13"):
        train.main(train.parse_args(["--preset", "tiny-spade", "--device", "cpu"]))
    # every dataset of the JAX package's factories is ported: a tiny EuroSAT
    # tree (--data_root) trains; an unknown name fails as in JAX
    rng = np.random.default_rng(0)
    for cls in ("Forest", "River"):
        os.makedirs(workdir / "eurosat" / cls)
        for j in range(5):
            Image.fromarray(rng.integers(0, 255, (8, 8, 3), np.uint8)).save(
                workdir / "eurosat" / cls / f"{cls}_{j}.jpg")
    res = train.main(train.parse_args([
        "--preset", "tiny", "--dataset", "eurosat", "--data_root", str(workdir / "eurosat"),
        "--device", "cpu", "--batch_size", "4", "--epochs", "1", "--sample_every", "0",
        "--save_every", "0", "--dir", "results/e"]))
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))  # 8 of 10 train, b4
    with pytest.raises(KeyError, match="no-such-dataset"):
        train.main(train.parse_args(["--preset", "tiny", "--dataset", "no-such-dataset",
                                     "--device", "cpu"]))


@pytest.mark.parametrize("preset", ["tiny-dit", "tiny-flow", "dit256"])
def test_dit_and_flow_training_raises_until_ported(workdir, preset):
    """The DiT and flow presets train now (the tests below), and so does each
    one's latent counterpart (tests/test_torch_latent_cli.py): the same
    backbone and a flow, both on the latent grid behind a first stage. The
    latent bridge trains too (tests/test_torch_entry_points.py), and so does
    MeanFlow (tests/test_torch_distill_cli.py): its preset builds the
    dual-time backbone with plain attention and the MeanFlow process; what
    still raises is SPADE, naming ROADMAP queue 13."""
    from eo_diffusion_torch.cli.presets import build_process, get_preset

    latent = get_preset({"tiny-dit": "tiny-latent-dit", "tiny-flow": "tiny-latent-flow",
                         "dit256": "latent256"}[preset])
    pixel = get_preset(preset)
    grid = (latent.latent_size, latent.latent_size, latent.latent_channels)
    cfg = latent.model_config()
    assert (cfg.image_size, cfg.image_size, cfg.in_channels) == grid
    assert type(cfg) is type(pixel.model_config()) and latent.process == "flow"
    proc = build_process(latent, latent.timesteps, latent.image_size)
    assert (proc.image_size, proc.image_size, proc.in_channels) == grid
    from eo_diffusion_torch.diffusion.meanflow import MeanFlow

    mf = get_preset("tiny-meanflow")
    mcfg = mf.model_config()
    assert mcfg.dual_time and mcfg.attn_impl == "plain"
    assert isinstance(build_process(mf, mf.timesteps, mf.image_size), MeanFlow)
    with pytest.raises(NotImplementedError, match="queue 13"):
        train.main(train.parse_args(["--preset", "tiny-spade", "--device", "cpu"]))


DIT_FLOW = ["--dataset", "synthetic", "--device", "cpu", "--batch_size", "4",
            "--steps_per_epoch", "2", "--epochs", "1", "--n_samples", "2", "--preview_steps", "3",
            "--sample_every", "2", "--save_every", "0", "--log_freq", "1"]


@pytest.mark.parametrize("preset,size", [("tiny-dit", 16), ("tiny-flow", 8)])
def test_dit_and_flow_presets_train_and_preview(workdir, capsys, monkeypatch, preset, size):
    """Two steps and a preview, then sampling from the checkpoint. A flow
    preset forces the flow preview (its ODE over ``preview_steps``
    intervals) whatever ``--preview_sampler`` says; the DiT's DDPM preset
    previews with DDIM as asked."""
    from eo_diffusion_torch.diffusion.flow import FlowMatching
    from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion

    previews = []
    for cls, name in ((FlowMatching, "sample"), (GaussianDiffusion, "ddim_sample")):
        real = getattr(cls, name)
        monkeypatch.setattr(cls, name, lambda self, *a, _r=real, _n=name, **kw: (
            previews.append((_n, kw["num_steps"])), _r(self, *a, **kw))[1])
    res = train.main(train.parse_args(["--preset", preset, "--dir", f"results/{preset}",
                                       "--preview_sampler", "ddim", *DIT_FLOW]))
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))
    assert type(res["state"].model).__name__ == ("DiT" if preset == "tiny-dit" else "UNet")
    assert previews == [("sample" if preset == "tiny-flow" else "ddim_sample", 3)]
    assert "done: 2 steps in" in capsys.readouterr().out
    assert os.path.exists(workdir / "results" / preset / "steps_00000002.png")
    args = inference.parse_args(["--preset", preset, "--dataset", "synthetic", "--device", "cpu",
                                 "--sampler", "ddim", "--sampler_steps", "2", "--n_iter", "0",
                                 "--batch_size", "2", "--ckpt", res["checkpoint"],
                                 "--outdir", str(workdir / "out")])
    x = torch.as_tensor(inference.main(args)["samples"])
    assert x.shape == (2, size, size, 3) and bool(torch.isfinite(x).all())


def test_preview_sampler_flow_needs_a_flow_preset_and_wandb_degrades(workdir, capsys):
    with pytest.raises(SystemExit, match="requires a flow-process preset"):
        train.main(train.parse_args(["--preset", "tiny", "--preview_sampler", "flow",
                                     "--device", "cpu"]))
    res = train.main(train.parse_args(["--preset", "tiny", "--wandb", "--dir", "results/w",
                                       *DIT_FLOW]))
    assert res["steps"] == 2
    if importlib.util.find_spec("wandb") is None:  # as the JAX CLI degrades
        assert "wandb unavailable (No module named 'wandb'); logging to stdout only" in (
            capsys.readouterr().out)


def test_no_gpu_without_device_cpu_fails_clearly(workdir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default --device cuda is valid")
    with pytest.raises(SystemExit) as exc:
        train.main(train.parse_args(["--preset", "tiny", "--dataset", "synthetic"]))
    assert "no CUDA device" in str(exc.value.code) and "--device cpu" in str(exc.value.code)
    assert not (workdir / "logs").exists()
