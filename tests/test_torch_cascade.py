"""The super-resolution stage and ``cli.cascade`` of the port against the
JAX package on the CPU, float32.

``data.transforms.sr_cond``, the SR training batch of ``cli.train``
(``_to_model_batch`` with the preset's ``sr_factor``) and the sampling
CLI's SR cond (``_build_cond``) are JAX's bit for bit. A ``tiny`` ->
``tiny-sr`` cascade (seeded weights, carried over) from shared start noise
holds JAX's two ``ddim_sample`` stages with the nearest upsample between
them, DDIM-5 each, within 5e-5 (max |port - JAX| / max |JAX|), and its
``cascade_rmse``: one jitted JAX function, the chain as the JAX CLI jits
it. ``cli.train --preset tiny-sr`` and ``cli.cascade`` run on the CPU and
write their files; the stage checks raise with JAX's messages."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.cli import cascade as TC
from eo_diffusion_torch.cli import inference as TI
from eo_diffusion_torch.cli import presets as TP
from eo_diffusion_torch.cli import train as TT
from eo_diffusion_torch.data.transforms import sr_cond as t_sr_cond
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_torch.weights import state_dict_from_jax_params
from eo_diffusion_tpu.cli import cascade as JC
from eo_diffusion_tpu.cli import inference as JI
from eo_diffusion_tpu.cli import presets as JP
from eo_diffusion_tpu.cli import train as JT
from eo_diffusion_tpu.data.transforms import sr_cond as j_sr_cond
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from torch_parity import fill_params, one_torch_thread, rel_err  # noqa: F401

TOL = 5e-5
N, STEPS = 2, 5


def test_sr_cond_and_the_sr_batches_bit_for_bit():
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    for f in (2, 4):
        np.testing.assert_array_equal(t_sr_cond(img, f), np.asarray(j_sr_cond(img, f)))
    batch = {"image": img, "class": np.arange(3)}
    got = TT._to_model_batch(batch, "concat", sr_factor=2)
    want = JT._to_model_batch(batch, "concat", sr_factor=2)
    assert sorted(got) == sorted(want) == ["cond", "image", "label"]
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    # the sampling CLI conditions on the degraded ground truth, not a paired view
    batch["cond_image"] = rng.uniform(-1, 1, img.shape).astype(np.float32)
    (gc, gm), (wc, wm) = (m._build_cond(batch, "concat", 16, sr_factor=2) for m in (TI, JI))
    np.testing.assert_array_equal(gc, np.asarray(wc))
    assert gm is None and wm is None


def _stage(name, seed, cond_channels=0):
    """A preset's JAX model with seeded params, and the port's twin."""
    jcfg = JP.get_preset(name).model_config(bf16=False, cond_channels=cond_channels)
    tcfg = TP.get_preset(name).model_config(bf16=False, cond_channels=cond_channels)
    jmodel = JP.build_denoiser(jcfg)
    s = jcfg.image_size
    kw = {"cond": jnp.zeros((1, s, s, cond_channels))} if cond_channels else {}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)),
                            jnp.zeros((1,), jnp.int32), **kw)
    params = fill_params(shapes, seed)
    tmodel = TP.build_denoiser(tcfg)
    tmodel.load_state_dict(state_dict_from_jax_params(params, tcfg), strict=True)
    return jmodel, params, tmodel.eval().requires_grad_(False)


def test_cascade_matches_jax_from_shared_noise():
    base, sr = TP.get_preset("tiny"), TP.get_preset("tiny-sr")
    jb, pb, tb = _stage("tiny", 91)
    js, ps, ts = _stage("tiny-sr", 92, cond_channels=3)
    rng = np.random.default_rng(93)
    xb_T = rng.normal(size=(N, 8, 8, 3)).astype(np.float32)
    xs_T = rng.normal(size=(N, 16, 16, 3)).astype(np.float32)
    f = sr.sr_factor

    @jax.jit
    def jcascade(xb_T, xs_T):
        bd = JGD.create(timesteps=base.timesteps, image_size=8, in_channels=3)
        sd = JGD.create(timesteps=sr.timesteps, image_size=16, in_channels=3,
                        cond_type="concat")
        xb = bd.ddim_sample(lambda x, t, c, y: jb.apply(pb, x, t, cond=c, y=y),
                            jax.random.PRNGKey(0), N, num_steps=STEPS, x_T=xb_T).x
        cond = jnp.repeat(jnp.repeat(xb, f, axis=1), f, axis=2)
        xs = sd.ddim_sample(lambda x, t, c, y: js.apply(ps, x, t, cond=c, y=y),
                            jax.random.PRNGKey(1), N, num_steps=STEPS, cond=cond, x_T=xs_T).x
        pooled = xs.reshape(N, 8, f, 8, f, 3).mean(axis=(2, 4))
        return xb, xs, jnp.sqrt(jnp.mean((pooled - xb) ** 2))

    jxb, jxs, jrmse = jcascade(jnp.asarray(xb_T), jnp.asarray(xs_T))
    bd = TP.build_process(base, base.timesteps, 8, cond_type=None)
    sd = TP.build_process(sr, sr.timesteps, 16, cond_type="concat")
    xb, xs, rmse = TC.cascade(base, bd, tb, sd, ts, f, N, device="cpu", base_steps=STEPS,
                              sr_steps=STEPS, base_x_T=torch.from_numpy(xb_T),
                              sr_x_T=torch.from_numpy(xs_T))
    assert isinstance(bd, TGD)
    assert rel_err(xb, jxb) <= TOL and rel_err(xs, jxs) <= TOL
    assert rmse == pytest.approx(float(jrmse), rel=TOL)


def test_train_sr_then_cascade_cli(tmp_path, monkeypatch):
    """Two steps of cli.train on tiny and on tiny-sr (the SR cond from the
    images), then cli.cascade from both checkpoints: its grids, the SR
    samples and the metrics file."""
    monkeypatch.chdir(tmp_path)
    ckpts = {}
    for preset in ("tiny", "tiny-sr"):
        res = TT.main(TT.parse_args([
            "--preset", preset, "--dataset", "synthetic", "--device", "cpu", "--batch_size",
            "4", "--epochs", "1", "--steps_per_epoch", "2", "--sample_every", "2",
            "--preview_sampler", "ddim", "--preview_steps", "2", "--save_every", "0",
            "--dir", f"results/{preset}"]))
        assert res["steps"] == 2 and all(np.isfinite(res["losses"]))
        ckpts[preset] = res["checkpoint"]
    # the SR preview is conditioned: its grid and the cond's beside it
    assert (tmp_path / "results" / "tiny-sr" / "steps_00000002_cond.png").is_file()
    sd = torch.load(ckpts["tiny-sr"], weights_only=False)["model"]
    assert sd["input_blocks.0.0.weight"].shape[1] == 6  # 3 + 3 concat channels
    out = tmp_path / "cascade"
    m = TC.main(TC.parse_args(["--base_preset", "tiny", "--base_ckpt", ckpts["tiny"],
                               "--sr_preset", "tiny-sr", "--sr_ckpt", ckpts["tiny-sr"],
                               "--n", "3", "--batch_size", "2", "--base_steps", "3",
                               "--sr_steps", "3", "--device", "cpu", "--outdir", str(out)]))
    assert {p.name for p in out.iterdir()} == {"base.png", "base_upsampled.png", "sr.png",
                                                "sr_samples.npy", "cascade_metrics.json"}
    saved = json.loads((out / "cascade_metrics.json").read_text())
    assert saved["n"] == 3 and saved["factor"] == 2 and np.isfinite(saved["cascade_rmse"])
    assert np.load(out / "sr_samples.npy").shape == (3, 16, 16, 3)
    assert m["sr_samples"].shape == (3, 16, 16, 3) and len(m["chunk_seconds"]) == 2


@pytest.mark.parametrize("base,sr,match", [
    ("tiny", "tiny", "must be an SR stage"),
    ("synthetic64", "tiny-sr", "grid mismatch"),
    ("tiny-cr", "tiny-sr", "must be unconditional"),
    ("tiny-latent", "tiny-sr", "pixel-space stages"),
])
def test_stage_checks_raise_as_in_jax(base, sr, match, tmp_path):
    argv = ["--base_preset", base, "--base_ckpt", "none", "--sr_preset", sr, "--sr_ckpt",
            "none", "--outdir", str(tmp_path)]
    with pytest.raises(AssertionError, match=match) as got:
        TC.main(TC.parse_args(argv + ["--device", "cpu"]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    with pytest.raises(AssertionError, match=match) as want:
        JC.main(JC.parse_args(argv))
    assert str(got.value) == str(want.value)
