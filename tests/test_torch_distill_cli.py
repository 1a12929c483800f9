"""The port's few-step entry points on the CPU (``--device cpu``), at tiny
presets, from seeded teacher checkpoints in the train state's layout:
``cli.distill`` with each of its four methods (ReFlow, consistency,
progressive, guided on a flow and on a DDPM teacher) writes a student
checkpoint and ``distill_metrics.json``, and ``cli.inference`` samples the
students with ``--sampler flow``, ``cm`` and ``pd``; the MeanFlow presets
train through ``cli.train`` (the CFG-integrated one with the loss's own
label dropout, the trainer's off) and sample through their native sampler
(its ``--flow_method`` forced to Euler).
No JAX here: the modules' parity is in test_torch_{meanflow, consistency,
progressive, distill}.py."""

import functools
import json
import os

import numpy as np
import pytest

from eo_diffusion_torch.cli import distill
from eo_diffusion_torch.cli import inference
from eo_diffusion_torch.cli import train
from eo_diffusion_torch.cli.presets import build_denoiser, get_preset
from eo_diffusion_torch.diffusion import distill as TDS
from eo_diffusion_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from eo_diffusion_torch.weights import randomize_parameters
from torch_parity import one_torch_thread  # noqa: F401

SMALL = ["--device", "cpu", "--no_bf16", "--steps", "2", "--n_pairs", "6", "--pool_n", "6",
         "--pair_steps", "3", "--pool_steps", "3", "--batch_size", "4", "--eval_n", "2",
         "--few_steps", "1", "2", "--pd_base_steps", "4", "--pd_rounds", "2"]
METHODS = {  # method -> (teacher preset, how cli.inference samples the student)
    "reflow": ("tiny-flow", ["--sampler", "flow", "--flow_method", "euler"]),
    "consistency": ("tiny", ["--sampler", "cm", "--cd_points", "18", "--sigma_data", "0.5"]),
    "progressive": ("tiny", ["--sampler", "pd"]),
    "guided_flow": ("tiny-cflow", ["--sampler", "flow"]),
    "guided_ddpm": ("tiny-cddpm", ["--sampler", "ddim"]),
}


def _teacher(tmp_path, preset):
    p = get_preset(preset)
    sd = randomize_parameters(build_denoiser(p.model_config(
        bf16=False, class_dropout_prob=p.class_dropout)), seed=3).state_dict()
    return save_checkpoint(tmp_path / "teachers", {"model": sd, "model_ema": sd}, name=preset)


@pytest.mark.parametrize("name", sorted(METHODS))
def test_each_method_distills_a_student_the_sampling_cli_loads(tmp_path, monkeypatch, name):
    """Each method end to end; the flow scores' Heun reference takes 4 steps
    here (64 in the CLI) to keep the CPU run short."""
    monkeypatch.setattr(TDS, "endpoint_gap", functools.partial(TDS.endpoint_gap, ref_steps=4))
    preset, sampler = METHODS[name]
    method = name.split("_")[0]
    out = tmp_path / "student"
    res = distill.main(distill.parse_args([
        "--preset", preset, "--method", method, "--ckpt", _teacher(tmp_path, preset),
        "--dir", str(out), *SMALL]))
    with open(out / "distill_metrics.json") as f:
        metrics = json.load(f)
    timing = res["timing"]["round2" if method == "progressive" else "step_seconds"]
    assert metrics["config"]["method"] == method and len(
        timing["step_seconds"] if method == "progressive" else timing) == 2
    score = {"reflow": "student", "consistency": "student", "progressive": "round2",
             "guided": "student"}[method]
    assert all(np.isfinite(v) for v in metrics[score].values())
    if method == "progressive":
        assert metrics["final_steps"] == 1 and metrics["student_objective"] == "v"
    raw = restore_checkpoint(res["checkpoint"])
    assert set(raw["model_ema"]) == set(raw["model"]) and raw["step"] >= 2
    steps = "1" if method == "progressive" else "2"
    got = inference.main(inference.parse_args([
        "--preset", preset, "--ckpt", res["checkpoint"], *sampler, "--sampler_steps", steps,
        "--device", "cpu", "--no_bf16", "--batch_size", "2", "--n_iter", "0",
        "--outdir", str(tmp_path / "samples")]))
    assert got["samples"].shape == (2, 8, 8, 3) and np.isfinite(got["samples"]).all()


def test_distill_refuses_a_teacher_of_the_wrong_process(tmp_path):
    with pytest.raises(AssertionError, match="DDPM-chain teacher"):
        distill.main(distill.parse_args(["--preset", "tiny-flow", "--method", "consistency",
                                         "--ckpt", "x", "--device", "cpu"]))
    with pytest.raises(AssertionError, match="ReFlow distills rectified flows"):
        distill.main(distill.parse_args(["--preset", "tiny", "--ckpt", "x", "--device", "cpu"]))
    with pytest.raises(SystemExit, match="null class row"):  # a teacher without the row
        p = get_preset("tiny-flow")
        sd = build_denoiser(p.model_config(bf16=False)).state_dict()
        path = save_checkpoint(tmp_path, {"model": sd, "model_ema": sd}, name="flow")
        distill.main(distill.parse_args(["--preset", "tiny-cflow", "--method", "guided",
                                         "--ckpt", path, *SMALL, "--dir", str(tmp_path / "o")]))


@pytest.mark.parametrize("argv,match", [
    (["--preset", "tiny-flow", "--sampler", "cm"], "consistency-distilled"),
    (["--preset", "tiny-meanflow", "--sampler", "pd"], "progressive-distilled"),
    (["--preset", "tiny", "--sampler", "cm", "--deepcache", "2"], "DeepCache does not apply"),
    (["--preset", "tiny", "--sampler", "pd", "--cond_type", "sum"], "no RePaint mask"),
])
def test_the_distilled_samplers_keep_the_jax_checks(tmp_path, argv, match):
    with pytest.raises(AssertionError, match=match):
        inference.main(inference.parse_args([*argv, "--device", "cpu", "--outdir",
                                             str(tmp_path)]))


@pytest.mark.parametrize("preset", ["tiny-meanflow", "tiny-cmeanflow", "tiny-dit-meanflow"])
def test_meanflow_presets_sample_through_the_native_sampler(tmp_path, capsys, monkeypatch,
                                                           preset):
    p = get_preset(preset)
    cfg = p.model_config(bf16=False, class_dropout_prob=0.1 if p.mf_cfg_omega != 1.0 else 0.0)
    assert cfg.dual_time and cfg.attn_impl == "plain"
    calls = []
    model = randomize_parameters(build_denoiser(cfg), seed=1)
    sd = model.state_dict()
    path = save_checkpoint(tmp_path, {"model": sd, "model_ema": sd}, name="mf")
    fwd = type(model).forward

    def counted(self, x, t, *a, **kw):
        calls.append(tuple(t.shape))
        return fwd(self, x, t, *a, **kw)

    monkeypatch.setattr(type(model), "forward", counted)
    res = inference.main(inference.parse_args([
        "--preset", preset, "--ckpt", path, "--flow_method", "heun", "--sampler_steps", "2",
        "--device", "cpu", "--no_bf16", "--batch_size", "2", "--n_iter", "0",
        "--outdir", str(tmp_path / "o")]))
    out = capsys.readouterr().out
    assert "using --sampler flow" in out and "ignoring --flow_method heun" in out
    assert calls == [(2, 2), (2, 2)]  # one call a segment, (t, r) packed
    size = p.image_size
    assert res["samples"].shape == (2, size, size, 3) and np.isfinite(res["samples"]).all()
    assert os.path.isdir(tmp_path / "o" / "samples")


@pytest.mark.parametrize("preset", ["tiny-meanflow", "tiny-cmeanflow"])
def test_meanflow_presets_train_through_the_cli(tmp_path, monkeypatch, capsys, preset):
    """Two steps of ``cli.train``: the MeanFlow loss (a torch.func.jvp through
    the dual-time UNet) backpropagates, the native preview samples, and the
    checkpoint samples through ``cli.inference``. The CFG-integrated preset
    gets the null row (class dropout 0.1) and the trainer leaves the
    dropout to the loss."""
    from eo_diffusion_torch.train.trainer import Trainer

    seen = []
    init = Trainer.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        seen.append((self.class_dropout_prob, self.model.config.class_dropout_prob))

    monkeypatch.setattr(Trainer, "__init__", spy)
    monkeypatch.chdir(tmp_path)
    res = train.main(train.parse_args([
        "--preset", preset, "--device", "cpu", "--no_bf16", "--batch_size", "4",
        "--steps_per_epoch", "2", "--epochs", "1", "--n_samples", "2", "--preview_steps", "2",
        "--sample_every", "2", "--save_every", "0", "--dir", "results/mf"]))
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))
    assert seen == ([(0.0, 0.1)] if preset == "tiny-cmeanflow" else [(0.0, 0.0)])
    assert (tmp_path / "results" / "mf" / "steps_00000002.png").exists()
    got = inference.main(inference.parse_args([
        "--preset", preset, "--ckpt", res["checkpoint"], "--sampler_steps", "1", "--device",
        "cpu", "--no_bf16", "--batch_size", "2", "--n_iter", "0", "--outdir", "out"]))
    assert got["samples"].shape == (2, 8, 8, 3) and np.isfinite(got["samples"]).all()
