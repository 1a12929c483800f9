"""The port's entry points on the CPU: ``cli.train`` -> ``cli.inference``
round trips of the EDM and bridge presets, the four demos of
``examples/torch/`` with ``--smoke --device cpu`` (run in process, writing
the files their JAX twins write), ``tools/jax_ckpt_to_torch.py`` on
checkpoints the JAX package saved (a UNet whose converted forward matches
JAX's, a latent bridge with its first stage that then samples through the
port's CLI), and the presets the port no longer refuses."""

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.cli import inference, presets as TP, train
from torch_parity import fill_params, one_torch_thread, rel_err  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NEW_PRESETS = ("edm64", "tiny-edm", "tiny-dit-edm", "bridge64", "tiny-bridge",
               "tiny-latent-bridge")


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"_entry_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("preset", ["tiny-edm", "tiny-bridge"])
def test_train_then_sample_round_trip(workdir, preset):
    """Two steps through the training CLI (the native preview of the
    process, its checkpoint), then the sampling CLI from that checkpoint:
    EDM Heun, the bridge's posterior walk at --eta 0."""
    res = train.main(train.parse_args([
        "--preset", preset, "--dataset", "synthetic", "--device", "cpu", "--batch_size", "4",
        "--epochs", "1", "--steps_per_epoch", "2", "--sample_every", "2",
        "--preview_sampler", "ddim", "--preview_steps", "3", "--save_every", "2",
        "--dir", f"results/{preset}"]))
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))
    assert (workdir / "results" / preset / "steps_00000002.png").is_file()
    ckpt = workdir / "logs" / preset / "steps_00000002"
    out = inference.main(inference.parse_args([
        "--preset", preset, "--dataset", "synthetic", "--device", "cpu", "--batch_size", "2",
        "--n_iter", "0", "--sampler_steps", "3", "--flow_method", "heun", "--eta", "0",
        "--ckpt", str(ckpt), "--outdir", str(workdir / "out"), "--save"]))
    assert out["samples"].shape == (2, 8, 8, 3) and np.isfinite(out["samples"]).all()
    assert (workdir / "out" / "samples" / "sample_0.png").is_file()


DEMOS = [
    ("cloud_removal_demo.py", ["--synthetic", "--smoke", "--ddim", "5"],
     ["input_cloudy.png", "cloud_mask.png", "cloud_removed.png"]),
    ("change_pair_demo.py", ["--synthetic", "--smoke"], ["before.png", "after_generated.png"]),
    ("inpainting_demo.py", ["--synthetic", "--smoke", "--sampler", "ddim"],
     ["original.png", "replan_region.png", "replanned.png"]),
    ("modern_stack_demo.py", ["--smoke", "--sample_steps", "2"], ["samples_heun2.png"]),
]


@pytest.mark.parametrize("script,args,artifacts", DEMOS, ids=[d[0] for d in DEMOS])
def test_demo_smoke_on_the_cpu(script, args, artifacts, workdir):
    mod = _load(ROOT / "examples" / "torch" / script)
    out = workdir / "out"
    res = mod.main(["--out", str(out), "--device", "cpu", *args])
    assert np.isfinite(res).all()
    for name in artifacts:
        assert (out / name).is_file() and (out / name).stat().st_size > 0, name


def test_a_demo_without_a_card_exits(workdir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default --device cuda is valid")
    mod = _load(ROOT / "examples" / "torch" / "inpainting_demo.py")
    with pytest.raises(SystemExit, match="--device cpu"):
        mod.main(["--smoke", "--out", str(workdir / "out")])
    assert not (workdir / "out").exists()


def _jax_model(preset, cond_channels, seed):
    """The preset's JAX backbone (f32) and seeded values for every leaf."""
    from eo_diffusion_tpu.cli import presets as JP

    cfg = JP.get_preset(preset).model_config(bf16=False, cond_channels=cond_channels)
    model = JP.build_denoiser(cfg)
    s = cfg.image_size
    kw = {"cond": jnp.zeros((1, s, s, cond_channels))} if cond_channels else {}
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, s, s, cfg.out_channels)), jnp.zeros((1,)), **kw)
    return model, fill_params(shapes, seed)


def test_converted_unet_matches_the_jax_forward(workdir):
    """A tiny-cr checkpoint the JAX package saved: the converted file's EMA
    weights give JAX's forward within 1e-5, and its raw weights are the
    checkpoint's params (which differ from the EMA's)."""
    from eo_diffusion_tpu.train.checkpoint import save_checkpoint

    tool = _load(ROOT / "tools" / "jax_ckpt_to_torch.py")
    model, params = _jax_model("tiny-cr", 3, seed=61)
    ema = jax.tree.map(lambda a: a * np.float32(0.9), params)
    save_checkpoint(str(workdir / "jax_logs"), {"params": params, "ema_params": ema,
                                                "step": np.int32(3)}, step=3)
    res = tool.main(["--preset", "tiny-cr", "--ckpt", str(workdir / "jax_logs/steps_00000003"),
                     "--out", str(workdir / "port/steps_00000003")])
    rng = np.random.default_rng(2)
    x, cond = (rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    t = np.array([3, 40], np.int32)
    ref = jax.jit(model.apply)(ema, jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(cond))
    port = TP.build_denoiser(res["config"])
    from eo_diffusion_torch.train.checkpoint import restore_params
    from eo_diffusion_torch.weights import load_reference_checkpoint

    raw, ema_sd = restore_params(res["out"])
    port.load_state_dict(load_reference_checkpoint(res["out"], res["config"]), strict=True)
    assert all(torch.equal(ema_sd[k], v) for k, v in port.state_dict().items())
    assert not torch.equal(raw["out.2.weight"], ema_sd["out.2.weight"])
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x), torch.from_numpy(t).long(),
                          cond=torch.from_numpy(cond))
    assert rel_err(out, ref) <= 1e-5


def test_converted_latent_bridge_samples_in_the_port(workdir):
    """tiny-latent-bridge from the JAX package: the denoiser and the first
    stage (orbax params/ beside it) convert into the files the port's
    sampling CLI reads, ae/ beside --ckpt, and the CLI samples from them."""
    from eo_diffusion_tpu.models.autoencoder import AutoencoderConfig, ConvAutoencoder
    from eo_diffusion_tpu.train import ae_trainer as JAT
    from eo_diffusion_tpu.train.checkpoint import save_checkpoint

    tool = _load(ROOT / "tools" / "jax_ckpt_to_torch.py")
    _, params = _jax_model("tiny-latent-bridge", 4, seed=62)
    save_checkpoint(str(workdir / "jl"), {"params": params, "ema_params": params}, step=1)
    acfg = AutoencoderConfig(in_channels=3, latent_channels=4, base_channels=16, num_down=1)
    ae_params = fill_params(jax.eval_shape(ConvAutoencoder(acfg).init, jax.random.PRNGKey(0),
                                           jnp.zeros((1, 16, 16, 3))), seed=63)
    JAT.save_ae(str(workdir / "jl" / "ae"), acfg, ae_params, 0.75)
    res = tool.main(["--preset", "tiny-latent-bridge", "--ckpt", str(workdir / "jl/steps_00000001"),
                     "--out", str(workdir / "pl/steps_00000001")])
    assert res["ae"] == str(workdir / "pl" / "ae")
    assert {p.name for p in (workdir / "pl" / "ae").iterdir()} == {"params.pt", "ae_meta.json"}
    out = inference.main(inference.parse_args([
        "--preset", "tiny-latent-bridge", "--dataset", "synthetic", "--device", "cpu",
        "--batch_size", "2", "--n_iter", "0", "--sampler_steps", "3",
        "--ckpt", str(workdir / "pl/steps_00000001"), "--outdir", str(workdir / "out")]))
    assert out["samples"].shape == (2, 16, 16, 3) and np.isfinite(out["samples"]).all()


def test_the_edm_and_bridge_presets_are_ported():
    """None of the six is refused any more, each builds its process, and
    what the port still refuses are the presets of ROADMAP items 13-14 (item
    12's MeanFlow presets are ported and match the JAX package's too)."""
    from eo_diffusion_torch.diffusion.bridge import BrownianBridge
    from eo_diffusion_torch.diffusion.edm import EDMProcess
    from eo_diffusion_tpu.cli import presets as JP

    for name in NEW_PRESETS:
        pre = TP.get_preset(name)
        proc = TP.build_process(pre, pre.timesteps, pre.image_size, pre.cond_type)
        assert isinstance(proc, EDMProcess if pre.process == "edm" else BrownianBridge), name
        assert TP.PRESETS[name] == TP.Preset(**{k: getattr(JP.PRESETS[name], k)
                                                for k in TP.Preset.__dataclass_fields__})
    for name in ("meanflow64", "tiny-meanflow", "cmeanflow64", "tiny-cmeanflow",
                 "tiny-dit-meanflow"):
        assert TP.PRESETS[name] == TP.Preset(**{k: getattr(JP.PRESETS[name], k)
                                                for k in TP.Preset.__dataclass_fields__})
    assert set(TP._LATER.values()) == {13, 14}
    assert set(TP._LATER) | set(TP.PRESETS) == set(JP.PRESETS)
    with pytest.raises(AssertionError, match="concat"):
        TP.build_process(TP.get_preset("tiny-bridge"), 50, 8, cond_type=None)
