"""The sampling CLI's solvers and guidance on the CPU (python -m
eo_diffusion_torch.cli.inference --device cpu): every solver and guidance
flag on the tiny presets (``tiny-cr``, ``tiny-cddpm``, ``tiny-cflow``,
``tiny-vpred``, ``tiny``, ``tiny-dit``), with the model calls each run makes counted, the JAX
CLI's compatibility checks, the flags that still exit naming their ROADMAP
item, and ``cli.train --posthoc_ema`` feeding ``--phema_sigma_rel`` and
``--autoguide_sigma_rel``. Seeded random weights, synthetic data."""

import os

import numpy as np
import pytest
import torch

from eo_diffusion_torch.cli import inference
from eo_diffusion_torch.ops import attention as A


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny CPU ops: one thread is several times faster
    yield
    torch.set_num_threads(n)


@pytest.fixture
def calls(monkeypatch):
    """Seeded random weights for the CLI's denoisers, and one record a
    forward call: (batch, "full" | "partial")."""
    from eo_diffusion_torch.cli import presets
    from eo_diffusion_torch.weights import randomize_parameters

    seen = []
    build = presets.build_denoiser

    def build_random(cfg):
        model = randomize_parameters(build(cfg), seed=0)
        model.register_forward_hook(
            lambda m, a, kw, out: seen.append(
                (a[0].shape[0], "partial" if kw.get("deep_cache") is not None else "full")),
            with_kwargs=True)
        return model

    monkeypatch.setattr(presets, "build_denoiser", build_random)
    return seen


def _run(tmp_path, preset, *argv, batch=2):
    args = inference.parse_args(["--preset", preset, "--dataset", "synthetic", "--device", "cpu",
                                 "--batch_size", str(batch), "--n_iter", "0", "--outdir",
                                 str(tmp_path / "out"), *argv])
    res = inference.main(args)
    x = torch.as_tensor(res["samples"])
    assert x.shape[0] == batch and bool(torch.isfinite(x).all())
    return res, args


# preset, flags, the model calls: (batch, kind) by run
B = 2
CASES = {
    "dpm-uniform-lambda": ("tiny-cr", ["--sampler", "dpm", "--sampler_steps", "4"],
                           [(B, "full")] * 4),
    "dpm-karras-threshold": ("tiny-cr", ["--sampler", "dpm", "--sampler_steps", "4",
                                         "--dpm_spacing", "karras", "--dynamic_threshold",
                                         "0.995"], [(B, "full")] * 4),
    "dpm-uniform-t": ("tiny-cr", ["--sampler", "dpm", "--sampler_steps", "3", "--dpm_spacing",
                                  "uniform_t"], [(B, "full")] * 3),
    "unipc": ("tiny-cr", ["--sampler", "unipc", "--sampler_steps", "3"], [(B, "full")] * 4),
    "ddim-cfg-rescale-interval": ("tiny-cr", ["--sampler", "ddim", "--sampler_steps", "5",
                                              "--guidance_scale", "3", "--guidance_rescale",
                                              "0.7", "--guidance_interval", "0.2,0.8"],
                                  [(2 * B, "full")] * 5),
    "unipc-cfg": ("tiny-cr", ["--sampler", "unipc", "--sampler_steps", "2", "--guidance_scale",
                              "2"], [(2 * B, "full")] * 3),
    "ddim-dynamic-threshold": ("tiny-cr", ["--sampler", "ddim", "--sampler_steps", "5",
                                           "--dynamic_threshold", "0.995"], [(B, "full")] * 5),
    "ddpm-dynamic-threshold": ("tiny", ["--sampler", "ddpm", "--timesteps", "6",
                                        "--dynamic_threshold", "0.9"], [(B, "full")] * 6),
    "deepcache": ("tiny-cr", ["--sampler", "ddim", "--sampler_steps", "5", "--deepcache", "3"],
                  [(B, "full"), (B, "partial"), (B, "partial"), (B, "full"), (B, "partial")]),
    "deepcache-cfg": ("tiny-cr", ["--sampler", "ddim", "--sampler_steps", "5", "--deepcache",
                                  "2", "--guidance_scale", "2"],
                      [(2 * B, "full"), (2 * B, "partial")] * 2 + [(2 * B, "full")]),
    "pag": ("tiny-cr", ["--sampler", "ddim", "--sampler_steps", "2", "--pag_scale", "2"],
            [(B, "full")] * 4),
    "pag-dit": ("tiny-dit", ["--sampler", "dpm", "--sampler_steps", "2", "--pag_scale", "1.5"],
                [(B, "full")] * 4),
    "sdedit": ("tiny-cr", ["--sampler", "ddim", "--sampler_steps", "10", "--sdedit_strength",
                           "0.5"], [(B, "full")] * 5),
    "sdedit-dpm-to-ddim": ("tiny-cr", ["--sampler", "dpm", "--sampler_steps", "4",
                                       "--sdedit_strength", "0.25"], [(B, "full")] * 1),
    "sdedit-flow": ("tiny-flow", ["--flow_method", "heun", "--sampler_steps", "4",
                                  "--sdedit_strength", "0.5"], [(B, "full")] * 3),
    "cddpm-ddim-label-cfg": ("tiny-cddpm", ["--sampler", "ddim", "--sampler_steps", "5",
                                            "--guidance_scale", "4", "--samples_fid"],
                             [(2 * B, "full")] * 5),
    "cddpm-dpm-label-cfg": ("tiny-cddpm", ["--sampler", "dpm", "--sampler_steps", "3",
                                           "--guidance_scale", "4"], [(2 * B, "full")] * 3),
    "cddpm-ddpm-label-cfg": ("tiny-cddpm", ["--sampler", "ddpm", "--timesteps", "4",
                                            "--guidance_scale", "2", "--guidance_interval",
                                            "0.3,1"], [(2 * B, "full")] * 4),
    "cflow-heun-cfg": ("tiny-cflow", ["--flow_method", "heun", "--sampler_steps", "3",
                                      "--guidance_scale", "2", "--guidance_rescale", "0.5"],
                       [(2 * B, "full")] * 5),
    "vpred-dpm": ("tiny-vpred", ["--sampler", "dpm", "--sampler_steps", "3"], [(B, "full")] * 3),
    "vpred-ddim-trailing": ("tiny-vpred", ["--sampler", "ddim", "--sampler_steps", "3",
                                           "--ddim_spacing", "trailing"], [(B, "full")] * 3),
    "num-classes-base-dim": ("tiny", ["--sampler", "ddim", "--sampler_steps", "2",
                                      "--num_classes", "4", "--class_dropout", "0.1",
                                      "--model_base_dim", "16", "--guidance_scale", "2"],
                             [(2 * B, "full")] * 2),
    "random-label-sum": ("tiny", ["--sampler", "dpm", "--sampler_steps", "2", "--cond_type",
                                  "sum", "--random_label", "--metrics"], [(B, "full")] * 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_new_flags_run_through_the_cli(tmp_path, calls, capsys, case):
    preset, argv, want = CASES[case]
    res, args = _run(tmp_path, preset, *argv)
    assert calls == want, calls
    out = capsys.readouterr().out
    if "--samples_fid" in argv:  # class-conditional exports carry the class name
        assert sorted(os.listdir(tmp_path / "out" / "samples_fid")) == [
            "class0_0-0.png", "class0_0-1.png"]
    if "sdedit-dpm" in case:
        assert "SDEdit runs the DDIM tail" in out and args.sampler == "ddim"
    if case == "num-classes-base-dim":
        assert "Diffusion with" in out and res["images"] == B
    if case == "random-label-sum":
        assert "metrics:" in out


def test_guidance_notes_and_pag_hits(tmp_path, calls, capsys):
    """Image-CFG on ddpm and CFG on an unconditional preset are ignored with
    the JAX CLI's notes; PAG's perturbed calls go through the identity
    branch (one hit an attention block)."""
    _run(tmp_path, "tiny-cr", "--sampler", "ddpm", "--timesteps", "3", "--guidance_scale", "2")
    assert "ddpm has no image-CFG path" in capsys.readouterr().out and calls == [(B, "full")] * 3
    calls.clear()
    _run(tmp_path, "tiny", "--sampler", "ddim", "--sampler_steps", "2", "--guidance_scale", "2")
    assert "needs class- or concat-conditioning" in capsys.readouterr().out
    assert calls == [(B, "full")] * 2
    h0 = A.identity_attention_hits()
    _run(tmp_path, "tiny-cr", "--sampler", "ddim", "--sampler_steps", "5", "--pag_scale", "2")
    assert A.identity_attention_hits() - h0 == 5  # tiny-cr: the middle block's, five steps


@pytest.mark.parametrize("argv,match", [
    (["--preset", "tiny-cr", "--autoguide_scale", "2", "--autoguide_sigma_rel", "0.05",
      "--guidance_scale", "2"], "autoguide_scale xor --guidance_scale"),
    (["--preset", "tiny-cr", "--autoguide_scale", "2"], "needs a degraded model"),
    (["--preset", "tiny-cr", "--pag_scale", "2", "--deepcache", "2"], "bypass the PAG"),
    (["--preset", "tiny-dit", "--deepcache", "2"], "DiT backbone has no"),
    (["--preset", "tiny-flow", "--dynamic_threshold", "0.99"], "no such site"),
    (["--preset", "tiny", "--cond_type", "sum", "--sdedit_strength", "0.5"], "SDEdit starts"),
])
def test_the_jax_compatibility_checks_hold(tmp_path, argv, match):
    args = inference.parse_args([*argv, "--device", "cpu", "--dataset", "synthetic",
                                 "--outdir", str(tmp_path)])
    with pytest.raises(AssertionError, match=match):
        inference.main(args)


@pytest.mark.parametrize("argv,item", [(["--sigma_data", "1"], 12),
                                       (["--cd_points", "9"], 12), (["--sampler", "pd"], 12),
                                       (["--freeu", "1,1,1,1"], 13), (["--lora", "x"], 14)])
def test_waiting_flags_exit_naming_their_item(capsys, argv, item):
    """Flags of later items exit naming theirs; item 12's (the distilled
    samplers' --sigma_data, --cd_points and --sampler pd) are ported and
    parse into the run's arguments."""
    if item == 12:
        args = inference.parse_args(["--preset", "tiny", *argv])
        flag, value = argv[0].lstrip("-"), argv[1]
        assert str(getattr(args, flag)) in (value, f"{value}.0")
        return
    with pytest.raises(SystemExit) as exc:
        inference.parse_args(["--preset", "tiny", *argv])
    assert exc.value.code == 2 and f"ROADMAP queue {item}" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="queue 13"):
        inference.main(inference.parse_args(["--preset", "tiny", "--cond_type", "spade",
                                             "--device", "cpu"]))


def test_posthoc_ema_feeds_phema_and_autoguide(tmp_path, monkeypatch, capsys):
    """``cli.train --posthoc_ema`` snapshots the tracks at --save_every and
    at the end; ``--phema_sigma_rel`` samples with their synthesis and
    ``--autoguide_sigma_rel`` / ``--autoguide_ckpt`` guide with a worse
    model (two model calls a step)."""
    from eo_diffusion_torch.cli import train

    monkeypatch.chdir(tmp_path)
    res = train.main(train.parse_args([
        "--preset", "tiny-cr", "--dataset", "synthetic", "--device", "cpu", "--epochs", "1",
        "--steps_per_epoch", "4", "--batch_size", "4", "--sample_every", "4",
        "--preview_sampler", "dpm", "--preview_steps", "2", "--save_every", "2",
        "--posthoc_ema", "--posthoc_gammas", "16.97,6.94", "--model_base_dim", "16",
        "--model_ema_steps", "1", "--dir", "results/ph"]))
    assert res["steps"] == 4 and os.path.exists("results/ph/steps_00000004.png")
    assert sorted(os.listdir("logs/ph/phema")) == [
        f"phema_{s:08d}_g{g}.npz" for s in (1, 3) for g in ("16.970000", "6.940000")]
    ckpt = os.path.join("logs", "ph", "steps_00000004")
    common = ["--preset", "tiny-cr", "--dataset", "synthetic", "--device", "cpu", "--ckpt", ckpt,
              "--model_base_dim", "16", "--sampler", "ddim", "--sampler_steps", "2",
              "--batch_size", "2", "--n_iter", "0", "--outdir", str(tmp_path / "o")]
    base = inference.main(inference.parse_args(common))["samples"]
    phema = inference.main(inference.parse_args(common + ["--phema_sigma_rel", "0.1"]))
    assert "posthoc-ema: synthesized sigma_rel=0.1" in capsys.readouterr().out
    assert np.isfinite(phema["samples"]).all() and not np.array_equal(phema["samples"], base)
    for extra in (["--autoguide_sigma_rel", "0.05"],
                  ["--autoguide_ckpt", os.path.join("logs", "ph", "steps_00000002"),
                   "--guidance_interval", "0.1,0.9"]):
        out = inference.main(inference.parse_args(common + ["--autoguide_scale", "2", *extra]))
        assert np.isfinite(out["samples"]).all() and not np.array_equal(out["samples"], base)
    # a resumed run restores the tracks from the newest snapshot pair
    train.main(train.parse_args([
        "--preset", "tiny-cr", "--dataset", "synthetic", "--device", "cpu", "--epochs", "2",
        "--steps_per_epoch", "4", "--batch_size", "4", "--sample_every", "0", "--save_every",
        "0", "--posthoc_ema", "--model_base_dim", "16", "--resume", "--dir", "results/ph"]))
    assert "tracks restored from snapshot step 3" in capsys.readouterr().out
    assert "phema_00000007_g16.970000.npz" in os.listdir("logs/ph/phema")
