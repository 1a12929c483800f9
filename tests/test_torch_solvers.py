"""The port's DPM-Solver++ and UniPC against the JAX package's (f32, CPU):
the solver time tables for the three spacings and the continuous UniPC
tables, and whole trajectories of a closed-form denoiser written once in jnp
and once in torch (no UNet compiles), with image- and label-CFG, the
CFG-rescale and interval, dynamic thresholding and the RePaint composite,
the JAX samplers' composite draws injected through ``noise_fn``. DPM-1M is
also held to a DDIM eta-0 step on the same grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.core import schedules as TS
from eo_diffusion_torch.diffusion import dpm_solver as TD
from eo_diffusion_torch.diffusion import unipc as TU
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_tpu.core import schedules as JS
from eo_diffusion_tpu.diffusion import dpm_solver as JD
from eo_diffusion_tpu.diffusion import unipc as JU
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from torch_parity import closed_form_denoiser as _denoiser
from torch_parity import one_torch_thread, rel_err  # noqa: F401

# whole-trajectory f32 sampler parity: max |port - jax| / max |jax|
TRAJ_TOL = 5e-5
# the float32 tables: the same gathers and logs of float32 values; numpy's
# and XLA's float32 log part in the last bit at about one entry in five, so
# the limit is on max |port - jax| / max |jax| of each table
TABLE_TOL = 1e-7
T, N, SIZE, STEPS = 1000, 2, 8, 6
SHAPE = (N, SIZE, SIZE, 3)


@pytest.mark.parametrize("spacing", ["uniform_lambda", "uniform_t", "karras"])
@pytest.mark.parametrize("zero_snr", [False, True])
def test_solver_time_tables_match_jax(spacing, zero_snr):
    for steps in (5, 20):
        js = JS.make_schedule(T, "cosine_eo", zero_terminal_snr=zero_snr)
        ts = TS.make_schedule(T, "cosine_eo", zero_terminal_snr=zero_snr)
        want = JD.solver_time_tables(js, steps, spacing)
        got = TD.solver_time_tables(ts, steps, spacing)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        assert len(set(got[0].tolist())) == steps + 1  # strictly decreasing, no h = 0 step
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == np.float32 and np.isfinite(g).all()
            assert rel_err(g, w) <= TABLE_TOL


def test_continuous_time_tables_match_jax():
    for steps in (3, 10):
        got = TU.continuous_time_tables(TS.make_schedule(T, "cosine_eo"), steps)
        want = JU.continuous_time_tables(JS.make_schedule(T, "cosine_eo"), steps)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and rel_err(g, w) <= TABLE_TOL


def _inputs():
    rng = np.random.default_rng(9)
    x_T = rng.normal(size=SHAPE).astype(np.float32)
    cond = rng.uniform(-1, 1, size=SHAPE).astype(np.float32)
    x0 = rng.uniform(-1, 1, size=SHAPE).astype(np.float32)
    mask = (rng.uniform(size=SHAPE[:3] + (1,)) > 0.5).astype(np.float32)
    return x_T, cond, x0, mask


# (sampler, order, guidance, inpaint, dynamic threshold, objective)
CASES = {
    "dpm2m-image-cfg-inpaint-threshold": ("dpm", 2, "image", True, 0.995, "eps"),
    "dpm1m-label-cfg": ("dpm", 1, "label", False, None, "eps"),
    "unipc1-label-cfg": ("unipc", 1, "label", False, None, "eps"),
    "unipc2-image-cfg-inpaint": ("unipc", 2, "image", True, None, "eps"),
    "unipc3-v-image-cfg-inpaint-threshold": ("unipc", 3, "image", True, 0.9, "v"),
}


def _case_kw(case):
    """The sampler keywords of a CASES entry (numpy arrays)."""
    _, order, guide, inpaint, thresh, _ = CASES[case]
    x_T, cond, x0, mask = _inputs()
    kw = dict(num_steps=STEPS, order=order, dynamic_threshold=thresh, clip=thresh is None)
    if guide == "image":
        kw.update(cond=cond, uncond=np.zeros_like(cond), guidance_scale=3.0,
                  guidance_rescale=0.7, guidance_interval=(0.1, 0.9))
    elif guide == "label":
        kw.update(y=np.array([0, 2]), y_uncond=np.array([4, 4]), guidance_scale=2.0)
    if inpaint:
        kw.update(mask=mask, x0=x0)
    return kw


@pytest.fixture(scope="module")
def jax_trajectories():
    """Every case's JAX trajectory from one jitted function (one compile)."""
    x_T = _inputs()[0]

    @jax.jit
    def run(x_T):
        out = {}
        for case, (sampler, *_, objective) in CASES.items():
            jd = JGD.create(timesteps=T, image_size=SIZE, in_channels=3, objective=objective)
            jfn = JD.dpm_solver_sample if sampler == "dpm" else JU.unipc_sample
            out[case] = jfn(jd, _denoiser(jnp), jax.random.PRNGKey(4), N, x_T=x_T, **{
                k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for k, v in _case_kw(case).items()}).x
        return out

    return {k: np.asarray(v) for k, v in run(jnp.asarray(x_T)).items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_trajectories_match_jax(jax_trajectories, case):
    sampler, _, _, inpaint, _, objective = CASES[case]
    x_T, _, x0, mask = _inputs()
    key = jax.random.PRNGKey(4)
    kw = _case_kw(case)
    want = jax_trajectories[case]
    # the composite draws: DPM's step keys; UniPC's node-0 key, then its step keys
    scan_rng = jax.random.split(key)[1]
    if sampler == "dpm":
        keys = list(jax.random.split(scan_rng, STEPS))
    else:
        k0, rest = jax.random.split(scan_rng)
        keys = [k0] + list(jax.random.split(rest, STEPS))
    draws = [torch.from_numpy(np.array(jax.random.normal(k, SHAPE, jnp.float32))) for k in keys]
    td = TGD.create(timesteps=T, image_size=SIZE, in_channels=3, objective=objective)
    tfn = TD.dpm_solver_sample if sampler == "dpm" else TU.unipc_sample
    calls = []
    counted = lambda *a: calls.append(1) or _denoiser(torch)(*a)
    got = tfn(td, counted, N, device="cpu", x_T=torch.from_numpy(x_T),
              noise_fn=lambda i, role: draws[i],
              **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                 for k, v in kw.items()}).x
    assert got.shape == SHAPE and rel_err(got, want) <= TRAJ_TOL
    assert len(calls) == STEPS + (sampler == "unipc")  # UniPC: S + 1 evaluations
    if inpaint:  # the final paste keeps the known pixels
        known = torch.from_numpy(mask).expand(SHAPE) > 0
        torch.testing.assert_close(got[known], torch.from_numpy(x0)[known], rtol=0, atol=0)


def test_dpm1m_is_ddim_eta0_on_its_grid():
    """DPM-Solver++(1M) without the clamp is the DDIM eta-0 update on the
    solver's own grid: x' = alpha' x0_hat + sigma' eps_hat."""
    x_T, cond, _, _ = _inputs()
    td = TGD.create(timesteps=T, image_size=SIZE, in_channels=3)
    fn = _denoiser(torch)
    c = torch.from_numpy(cond)
    for spacing in ("uniform_lambda", "karras"):
        got = TD.dpm_solver_sample(td, fn, N, device="cpu", num_steps=STEPS, order=1,
                                   clip=False, cond=c, x_T=torch.from_numpy(x_T),
                                   time_spacing=spacing).x
        ts = TD.solver_time_tables(td.schedule, STEPS, spacing)[0]
        acp = td.schedule.alphas_cumprod
        x = torch.from_numpy(x_T).double()
        for cur, nxt in zip(ts[:-1], ts[1:]):
            eps = fn(x.float(), torch.full((N,), int(cur)), c, None).double()
            x0_hat = (x - np.sqrt(1 - acp[cur]) * eps) / np.sqrt(acp[cur])
            x = np.sqrt(acp[nxt]) * x0_hat + np.sqrt(1 - acp[nxt]) * eps
        assert rel_err(got, x.float()) <= TRAJ_TOL
