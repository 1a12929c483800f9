"""The latent presets through the port's CLIs on the CPU: ``cli.train`` trains
the first stage, saves it under ``logs/<run>/ae`` and trains the denoiser on
the encoded grid with pixel-space previews; a second run reuses the saved
first stage; ``cli.inference`` samples from the checkpoint and decodes;
``--ae_ckpt`` puts the first stage elsewhere and is needed to find it."""

import json
import os

import numpy as np
import pytest
import torch

from eo_diffusion_torch.cli import inference, train
from eo_diffusion_torch.train import trainer as TR
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

COMMON = ["--dataset", "synthetic", "--device", "cpu", "--batch_size", "4", "--epochs", "1",
          "--steps_per_epoch", "2", "--n_samples", "2", "--sample_every", "2",
          "--save_every", "0", "--log_freq", "1", "--preview_sampler", "ddim",
          "--preview_steps", "2", "--ae_steps", "3"]
# preset -> (pixel size, latent grid, sampler flags)
PRESETS = {"tiny-latent": (16, (8, 8, 4), ["--sampler", "ddim", "--sampler_steps", "2"]),
           "tiny-latent-cr": (16, (4, 4, 4), ["--sampler", "flow", "--sampler_steps", "2"]),
           "tiny-latent-flow": (16, (8, 8, 4), ["--sampler", "flow", "--flow_method", "heun",
                                                "--sampler_steps", "2"])}


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the CLI writes logs/ and results/ under the cwd
    return tmp_path


@pytest.fixture()
def previews(monkeypatch):
    """The shapes the trainer's previews come out in."""
    shapes = []
    real = TR.Trainer.sample
    monkeypatch.setattr(TR.Trainer, "sample", lambda self, *a, **kw: (
        lambda x: shapes.append(tuple(x.shape)) or x)(real(self, *a, **kw)))
    return shapes


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_train_saves_first_stage_then_reuses_it_and_samples(workdir, capsys, previews, preset):
    size, grid, sampler = PRESETS[preset]
    res = train.main(train.parse_args(["--preset", preset, "--dir", "results/l", *COMMON]))
    out = capsys.readouterr().out
    ae_dir = os.path.join("logs", "l", "ae")
    assert "training first stage: 3 steps -> " + ae_dir in out and "first stage saved" in out
    assert res["ae"]["trained"] and res["ae"]["dir"] == ae_dir
    assert len(res["ae"]["step_seconds"]) == 3 and np.isfinite(res["ae"]["scale_factor"])
    assert sorted(os.listdir(ae_dir)) == ["ae_meta.json", "params.pt"]
    with open(os.path.join(ae_dir, "ae_meta.json")) as f:
        assert json.load(f)["scale_factor"] == res["ae"]["scale_factor"]
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))
    model_cfg = res["state"].model.config
    assert (model_cfg.image_size, model_cfg.image_size, model_cfg.out_channels) == grid
    assert previews == [(2, size, size, 3)]  # decoded to pixels
    cond = os.path.exists(workdir / "results" / "l" / "steps_00000002_cond.png")
    assert os.path.exists(workdir / "results" / "l" / "steps_00000002.png")
    assert cond == (preset == "tiny-latent-cr")

    # a second run finds the saved first stage and trains on it
    res2 = train.main(train.parse_args(["--preset", preset, "--dir", "results/l", *COMMON]))
    assert f"loading first stage from {ae_dir}" in capsys.readouterr().out
    assert not res2["ae"]["trained"] and res2["ae"]["scale_factor"] == res["ae"]["scale_factor"]

    args = inference.parse_args(["--preset", preset, "--dataset", "synthetic", "--device", "cpu",
                                 *sampler, "--n_iter", "0", "--batch_size", "2", "--metrics",
                                 "--ckpt", res2["checkpoint"], "--outdir", str(workdir / "out")])
    got = inference.main(args)
    x = torch.as_tensor(got["samples"])
    assert x.shape == (2, size, size, 3) and bool(torch.isfinite(x).all())
    if preset == "tiny-latent-cr":  # scored against the ground truth, in pixels
        assert got["ssim"] != 0.0 and np.isfinite(got["psnr"])


def test_ae_ckpt_places_and_finds_the_first_stage(workdir, capsys):
    ae_dir = str(workdir / "elsewhere" / "ae")
    res = train.main(train.parse_args(["--preset", "tiny-latent-cr", "--dir", "results/e",
                                       "--ae_ckpt", ae_dir, *COMMON, "--sample_every", "0"]))
    assert res["ae"]["dir"] == ae_dir and os.path.exists(os.path.join(ae_dir, "params.pt"))
    assert not os.path.exists(workdir / "logs" / "e" / "ae")
    capsys.readouterr()
    argv = ["--preset", "tiny-latent-cr", "--dataset", "synthetic", "--device", "cpu",
            "--sampler_steps", "2", "--n_iter", "0", "--batch_size", "2",
            "--ckpt", res["checkpoint"], "--outdir", str(workdir / "out")]
    with pytest.raises(FileNotFoundError, match="needs a trained first stage"):
        inference.main(inference.parse_args(argv))
    x = inference.main(inference.parse_args(argv + ["--ae_ckpt", ae_dir]))["samples"]
    assert x.shape == (2, 16, 16, 3) and np.isfinite(x).all()
    assert "using --sampler flow" in capsys.readouterr().out  # a flow preset forces it
