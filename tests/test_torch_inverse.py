"""DDNM restoration of the port against eo_diffusion_tpu's (f32, CPU): the
three operators and the projector (to float32 rounding, A(A+ y) = y
included), ``ddnm_sample`` at eta 0 and with the JAX package's draws
injected (one jitted JAX function computes the restorations and the draws,
over a closed-form denoiser), and ``cli.restore`` on the tiny preset for
every task with ``--device cpu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion import inverse as TI
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_tpu.diffusion import inverse as JI
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from torch_parity import closed_form_denoiser, one_torch_thread, rel_err  # noqa: F401

TRAJ_TOL = 5e-5  # whole restoration: max |port - jax| / max |jax|
F32 = dict(rtol=1e-6, atol=1e-6)  # float32 rounding of a mean / a sum of three terms
T, STEPS, SHAPE = 40, 5, (2, 8, 8, 3)
# (task, operator args, eta): eta 0 draws nothing; eta > 0 replays the JAX draws
CASES = [("sr", 4, 0.0), ("inpaint", None, 0.85), ("gray", 3, 0.5)]


def _ops(lib_ops, mask):
    return {"sr": lib_ops.sr_operator(4), "inpaint": lib_ops.inpaint_operator(mask),
            "gray": lib_ops.gray_operator(3)}


def _data():
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, size=SHAPE).astype(np.float32)
    mask = (rng.uniform(size=SHAPE[:3] + (1,)) > 0.4).astype(np.float32)
    return x, mask


def _jax_draws(key):
    """x_T and the per-step eta draws exactly as JGD.ddim_sample takes them."""
    init_rng, k = jax.random.split(key)
    draws = []
    for _ in range(STEPS):
        k, nk, _mk = jax.random.split(k, 3)
        draws.append(jax.random.normal(nk, SHAPE, jnp.float32))
    return jax.random.normal(init_rng, SHAPE, jnp.float32), jnp.stack(draws)


@pytest.fixture(scope="module")
def refs():
    x, mask = _data()
    jd = JGD.create(timesteps=T, image_size=8, in_channels=3)
    ops = _ops(JI, jnp.asarray(mask))
    keys = [jax.random.PRNGKey(20 + i) for i in range(len(CASES))]

    @jax.jit
    def run(x, keys):
        return [(JI.ddnm_sample(jd, closed_form_denoiser(jnp), k, ops[name].forward(x),
                                ops[name], num_steps=STEPS, eta=eta).x, *_jax_draws(k))
                for (name, _, eta), k in zip(CASES, keys)]

    return [tuple(np.array(a) for a in o) for o in run(jnp.asarray(x), keys)]


@pytest.mark.parametrize("name", ["sr", "inpaint", "gray"])
def test_operators_and_projector_match_jax(name):
    x, mask = _data()
    x2 = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    jop, top = _ops(JI, jnp.asarray(mask))[name], _ops(TI, torch.from_numpy(mask))[name]
    y = np.asarray(jop.forward(jnp.asarray(x)))
    ty = top.forward(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), y, **F32)
    np.testing.assert_allclose(top.pinv(ty).numpy(), np.asarray(jop.pinv(jnp.asarray(y))), **F32)
    # A(A+ y) = y: A+ is a right inverse on A's range
    np.testing.assert_allclose(top.forward(top.pinv(ty)).numpy(), ty.numpy(), **F32)
    proj = TI.ddnm_projector(top, ty)(torch.from_numpy(x2))
    np.testing.assert_allclose(
        proj.numpy(), np.asarray(JI.ddnm_projector(jop, jnp.asarray(y))(jnp.asarray(x2))), **F32)
    np.testing.assert_allclose(top.forward(proj).numpy(), ty.numpy(), **F32)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_ddnm_sample_matches_jax(refs, case):
    ref, x_T, draws = refs[case]
    name, _, eta = CASES[case]
    x, mask = _data()
    op = _ops(TI, torch.from_numpy(mask))[name]
    y = op.forward(torch.from_numpy(x))
    td = TGD.create(timesteps=T, image_size=8, in_channels=3)
    out = TI.ddnm_sample(td, closed_form_denoiser(torch), y, op, num_steps=STEPS, eta=eta,
                         x_T=torch.from_numpy(x_T),
                         noise_fn=lambda i, role: torch.from_numpy(draws[i])).x
    assert out.dtype == torch.float32 and rel_err(out, ref) <= TRAJ_TOL
    # the final projection makes the restoration consistent with y exactly
    np.testing.assert_allclose(op.forward(out).numpy(), y.numpy(), **F32)


def test_ddnm_refuses_a_shape_the_process_does_not_take():
    td = TGD.create(timesteps=T, image_size=16, in_channels=3)
    with pytest.raises(AssertionError, match="A\\+ y has shape"):
        TI.ddnm_sample(td, closed_form_denoiser(torch), torch.zeros(2, 2, 2, 3),
                       TI.sr_operator(4), num_steps=2)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """Seeded weights of the tiny preset's UNet, saved as a training
    checkpoint of the port."""
    from eo_diffusion_torch.cli.presets import build_denoiser, get_preset
    from eo_diffusion_torch.train.checkpoint import save_checkpoint
    from eo_diffusion_torch.weights import randomize_parameters

    model = randomize_parameters(build_denoiser(get_preset("tiny").model_config()), 4)
    sd = {k: v * 0.3 for k, v in model.state_dict().items()}
    return save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), {"model": sd, "model_ema": sd},
                           name="best")


@pytest.mark.parametrize("task", ["sr2", "sr4", "inpaint", "colorize"])
def test_restore_cli_each_task(tmp_path, tiny_ckpt, task):
    from eo_diffusion_torch.cli import restore

    res = restore.main(restore.parse_args([
        "--preset", "tiny", "--ckpt", tiny_ckpt, "--task", task, "--device", "cpu",
        "--sampler_steps", "3", "--batch_size", "2", "--n_iter", "0", "--metrics", "--save",
        "--outdir", str(tmp_path)]))
    assert res["batches"] == 1 and res["restored"].shape == (2, 8, 8, 3)
    assert np.isfinite(res["restored"]).all() and res["range_err"] <= 1e-6
    for tag in ("gt", "input", "restored"):
        assert (tmp_path / f"{task}_0_{tag}.png").exists()
    text = (tmp_path / "metrics.txt").read_text()
    assert "ssim_naive" in text and "length: 1" in text


def test_restore_cli_ensemble_and_checks(tmp_path, tiny_ckpt):
    from eo_diffusion_torch.cli import restore

    argv = ["--preset", "tiny", "--ckpt", tiny_ckpt, "--device", "cpu", "--sampler_steps", "2",
            "--batch_size", "2", "--n_iter", "0", "--outdir", str(tmp_path)]
    res = restore.main(restore.parse_args([*argv, "--ensemble", "2", "--metrics", "--save"]))
    assert np.isfinite(res["unc_err_corr"]) and res["range_err"] <= 1e-6
    assert (tmp_path / "sr4_0_uncertainty.png").exists()
    with pytest.raises(AssertionError, match="eta > 0"):
        restore.main(restore.parse_args([*argv, "--ensemble", "2", "--eta", "0"]))
    with pytest.raises(AssertionError, match="not wired"):
        restore.main(restore.parse_args([*argv, "--preset", "tiny-flow"]))
    assert restore.parse_args(["--ckpt", "c"]).preset == "inria64"
