"""The port's sampling CLI (python -m eo_diffusion_torch.cli.inference) on the
CPU: tiny presets, synthetic data, random initial weights."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny CPU ops: one thread is several times faster
    yield
    torch.set_num_threads(n)


def _cli(*argv):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "eo_diffusion_torch.cli.inference", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_tiny_cr_ddim_writes_grids(tmp_path):
    res = _cli("--preset", "tiny-cr", "--dataset", "synthetic", "--device", "cpu",
               "--sampler", "ddim", "--sampler_steps", "5", "--n_iter", "0", "--save",
               "--batch_size", "4", "--outdir", str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Diffusion with" in res.stdout and "on cpu" in res.stdout
    # concat conditioning: the sample grid, the clear target and the cloudy view
    assert sorted(os.listdir(tmp_path / "samples")) == [
        "sample_0.png", "sample_0_cond.png", "sample_0_gt.png"]


def test_tiny_ddpm_runs_in_process(tmp_path):
    from eo_diffusion_torch.cli import inference

    args = inference.parse_args(["--preset", "tiny", "--sampler", "ddpm", "--device", "cpu",
                                 "--timesteps", "10", "--batch_size", "2", "--n_iter", "1",
                                 "--outdir", str(tmp_path)])
    res = inference.main(args)
    assert res["batches"] == 2 and res["images"] == 4
    x = torch.as_tensor(res["samples"])
    assert x.shape == (2, 8, 8, 3) and bool(torch.isfinite(x).all())


def test_no_gpu_without_device_cpu_fails_clearly(tmp_path):
    """In process (the python -m path runs in test_tiny_cr_ddim_writes_grids):
    the default --device cuda exits with a message naming --device cpu, a
    non-zero exit status, before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default --device cuda is valid")
    from eo_diffusion_torch.cli import inference

    with pytest.raises(SystemExit) as exit_:
        inference.main(inference.parse_args([
            "--preset", "tiny", "--sampler", "ddim", "--sampler_steps", "2", "--n_iter", "0",
            "--outdir", str(tmp_path)]))
    assert "no CUDA device" in str(exit_.value.code) and "--device cpu" in str(exit_.value.code)
    assert not (tmp_path / "samples").exists()


def test_unported_presets_and_datasets_raise(tmp_path):
    from PIL import Image

    from eo_diffusion_torch.cli import inference
    from eo_diffusion_torch.cli.presets import get_preset

    with pytest.raises(NotImplementedError, match="queue 13"):
        get_preset("tiny-spade")
    assert get_preset("tiny-meanflow").process == "meanflow"  # ported (queue 12)
    with pytest.raises(ValueError):
        get_preset("no-such-preset")
    # every dataset of the JAX package's factories is ported: a tiny EuroSAT
    # tree (--data_root) feeds the sampler; an unknown name fails as in JAX
    rng = np.random.default_rng(0)
    for cls in ("Forest", "River"):
        os.makedirs(tmp_path / "eurosat" / cls)
        for j in range(7):
            Image.fromarray(rng.integers(0, 255, (8, 8, 3), np.uint8)).save(
                tmp_path / "eurosat" / cls / f"{cls}_{j}.jpg")
    res = inference.main(inference.parse_args([
        "--preset", "tiny", "--dataset", "eurosat", "--data_root", str(tmp_path / "eurosat"),
        "--device", "cpu", "--sampler", "ddim", "--sampler_steps", "2", "--batch_size", "2",
        "--n_iter", "0", "--outdir", str(tmp_path / "out")]))
    assert res["batches"] == 1 and res["samples"].shape == (2, 8, 8, 3)
    with pytest.raises(KeyError, match="no-such-dataset"):
        inference.main(inference.parse_args(["--preset", "tiny", "--dataset",
                                             "no-such-dataset", "--device", "cpu"]))


def test_tiny_dit_ddim_runs_in_process(tmp_path):
    from eo_diffusion_torch.cli import inference

    args = inference.parse_args(["--preset", "tiny-dit", "--sampler", "ddim", "--sampler_steps",
                                 "3", "--device", "cpu", "--batch_size", "2", "--n_iter", "0",
                                 "--outdir", str(tmp_path)])
    res = inference.main(args)
    x = torch.as_tensor(res["samples"])
    assert x.shape == (2, 16, 16, 3) and bool(torch.isfinite(x).all())


@pytest.fixture
def counted_model(monkeypatch):
    """Seeded random weights for the CLI's denoiser (a fresh one outputs zeros)
    and a count of its forward calls."""
    from eo_diffusion_torch.cli import presets
    from eo_diffusion_torch.weights import randomize_parameters

    calls = []
    build = presets.build_denoiser

    def build_random(cfg):
        model = randomize_parameters(build(cfg), seed=0)
        model.register_forward_hook(lambda *a: calls.append(1))
        return model

    monkeypatch.setattr(presets, "build_denoiser", build_random)
    return calls


@pytest.mark.parametrize("method,calls", [("euler", 3), ("heun", 5)])
def test_tiny_flow_forces_the_flow_sampler(tmp_path, capsys, counted_model, method, calls):
    from eo_diffusion_torch.cli import inference

    args = inference.parse_args(["--preset", "tiny-flow", "--sampler", "ddim", "--flow_method",
                                 method, "--sampler_steps", "3", "--device", "cpu",
                                 "--batch_size", "2", "--n_iter", "0", "--outdir", str(tmp_path)])
    res = inference.main(args)
    assert "using --sampler flow" in capsys.readouterr().out and args.sampler == "flow"
    # Heun: two model calls an interval but one on the last
    assert len(counted_model) == calls
    x = torch.as_tensor(res["samples"])
    assert x.shape == (2, 8, 8, 3) and bool(torch.isfinite(x).all())


def test_flow_sampler_on_a_ddpm_preset_and_unported_flags_exit(tmp_path, capsys):
    from eo_diffusion_torch.cli import inference
    from eo_diffusion_torch.cli.presets import get_preset

    with pytest.raises(SystemExit, match="flow-process preset"):
        inference.main(inference.parse_args(["--preset", "tiny-dit", "--sampler", "flow",
                                             "--device", "cpu", "--outdir", str(tmp_path)]))
    # the few-step flags and samplers (queue 12) parse and reach the run now
    args = inference.parse_args(["--preset", "tiny", "--sigma_data", "0.5", "--sampler", "cm"])
    assert (args.sigma_data, args.sampler, args.cd_points) == (0.5, "cm", 18)
    for argv, queue in ((["--freeu", "1,1,1,1"], 13), (["--lora", "x"], 14),
                        (["--int8_compute"], 15)):
        with pytest.raises(SystemExit) as exc:
            inference.parse_args(["--preset", "tiny", *argv])
        assert exc.value.code == 2 and f"queue {queue}" in capsys.readouterr().err
    for name in ("tiny-meanflow", "tiny-dit-meanflow"):
        assert get_preset(name).model_config().dual_time
    for name, queue in (("tiny-spade", 13), ("tiny-sr", 14), ("moe-dit64", 13)):
        with pytest.raises(NotImplementedError, match=f"queue {queue}"):
            get_preset(name)


def test_metrics_and_samples_fid_on_tiny_cr(tmp_path, capsys, counted_model):
    """``--metrics --samples_fid`` (``--wandb`` parsed): metrics.txt holds the
    JAX package's SSIM and PSNR of the same samples against the ground truth
    (the test split's first batch) within 1e-5 relative, and every sample is
    a PNG of its own under samples_fid/."""
    import jax.numpy as jnp
    from PIL import Image

    from eo_diffusion_torch.cli import inference
    from eo_diffusion_torch.data.factories import DATASET_FACTORIES
    from eo_diffusion_torch.utils.images import rescale_to_unit, to_uint8
    from eo_diffusion_tpu.utils import metrics as JM

    args = inference.parse_args(["--preset", "tiny-cr", "--dataset", "synthetic", "--device",
                                 "cpu", "--sampler", "ddim", "--sampler_steps", "2",
                                 "--batch_size", "4", "--n_iter", "0", "--metrics",
                                 "--samples_fid", "--wandb", "--outdir", str(tmp_path)])
    res = inference.main(args)
    loader = DATASET_FACTORIES["synthetic"](batch_size=4, image_size=8, channels=3,
                                            with_cond_image=True)[1]
    data_range = loader.dataset.data_range
    gt01 = rescale_to_unit(np.asarray(next(iter(loader))["image"], np.float32), data_range)
    s01 = rescale_to_unit(res["samples"], data_range)
    want = {"ssim": float(JM.ssim(jnp.asarray(s01), jnp.asarray(gt01))),
            "psnr": float(JM.psnr(jnp.asarray(s01), jnp.asarray(gt01)))}
    lines = (tmp_path / "metrics.txt").read_text().splitlines()
    got = dict(line.split(": ") for line in lines)
    assert got["length"] == "1" and "metrics: " in capsys.readouterr().out
    for k, v in want.items():
        assert abs(float(got[k]) - v) <= 1e-5 * abs(v), (k, got[k], v)
        assert float(got[k]) == res[k]
    fid = sorted(os.listdir(tmp_path / "samples_fid"))
    assert fid == [f"sample_0-{i}.png" for i in range(4)]
    for i, name in enumerate(fid):  # one image, in a 2 px frame as the grids have
        png = np.asarray(Image.open(tmp_path / "samples_fid" / name))
        np.testing.assert_array_equal(png[2:-2, 2:-2], to_uint8(s01[i]))


class _SetUpDone(Exception):
    pass


@pytest.mark.parametrize("name,argv", [
    ("inference", ["--preset", "tiny-cr", "--dataset", "synthetic"]),
    ("train", ["--preset", "tiny-cr", "--dataset", "synthetic"]),
    ("restore", ["--preset", "tiny", "--dataset", "synthetic", "--ckpt", "c"]),
    ("evaluate", ["--real", "r", "--fake", "f"]),
    ("train_classifier", ["--preset", "tiny"]),
])
def test_cli_set_up_switches_tf32_off(monkeypatch, name, argv):
    """Every CLI resolves its device through cli.common.resolve_device, which
    leaves TF32 off for float32 matmuls and cuDNN convolutions (cuDNN's own
    default is on), so --no_bf16 and the classifier run in full float32."""
    import importlib

    from eo_diffusion_torch.cli import common

    mod = importlib.import_module(f"eo_diffusion_torch.cli.{name}")

    def stop_after(device, program):
        common.resolve_device(device, program)
        raise _SetUpDone

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(mod, "resolve_device", stop_after)
    with pytest.raises(_SetUpDone):
        mod.main(mod.parse_args([*argv, "--device", "cpu"]))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
