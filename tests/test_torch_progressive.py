"""Progressive distillation in the port (eo_diffusion_torch.diffusion.progressive)
against the JAX package's ``ProgressiveDistillation`` and ``pd_sample``,
float32 on the CPU: the grids, the two-steps-into-one loss (eps, x0 and v
teachers, a labelled student) with the JAX draws of the student steps and
eps injected, and ``pd_sample``'s trajectories at 1-4 steps, with and
without the clamp, a v head and an eps head. Teacher and student are
closed-form denoisers, so the one jitted JAX function compiles no network."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_torch.diffusion.progressive import ProgressiveDistillation as TPD
from eo_diffusion_torch.diffusion.progressive import _grid as t_grid
from eo_diffusion_torch.diffusion.progressive import pd_sample as t_pd_sample
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from eo_diffusion_tpu.diffusion.progressive import ProgressiveDistillation as JPD
from eo_diffusion_tpu.diffusion.progressive import _grid as j_grid
from eo_diffusion_tpu.diffusion.progressive import pd_sample as j_pd_sample
from torch_parity import one_torch_thread, rel_err  # noqa: F401

REL_TOL = 1e-5   # losses
TRAJ_TOL = 5e-5  # sampler trajectories
N, SIZE, T = 3, 8, 50
LOSS_CASES = {  # teacher objective, student steps, labels
    "eps_teacher_2": ("eps", 2, False),
    "x0_teacher_3": ("x0", 3, False),
    "v_teacher_4_label": ("v", 4, True),
}
SAMPLE_CASES = {  # steps, objective, clip
    "v_1": (1, "v", True), "v_2": (2, "v", True), "v_3_noclip": (3, "v", False),
    "eps_4": (4, "eps", True),
}


def _net(lib, a):
    def fn(x, t, c=None, y=None):
        tt = (t.astype(jnp.float32) if lib is jnp else t.float()) / T
        out = a * x + lib.sin(x) * tt[:, None, None, None] - 0.05
        if y is not None:
            yy = y.astype(jnp.float32) if lib is jnp else y.float()
            out = out + 0.1 * yy[:, None, None, None] * (1.0 + 0.5 * x)
        return out
    return fn


def _chain(lib_gd, objective="eps"):
    return lib_gd.create(timesteps=T, image_size=SIZE, in_channels=3, objective=objective)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(1)
    x0 = np.clip(rng.normal(size=(N, SIZE, SIZE, 3)), -1, 1).astype(np.float32)
    x_T = rng.normal(size=(N, SIZE, SIZE, 3)).astype(np.float32)
    y = np.array([0, 1, 2], np.int32)
    key = jax.random.PRNGKey(4)
    i_rng, n_rng = jax.random.split(key)
    draws = {name: (np.asarray(jax.random.randint(i_rng, (N,), 0, n)),
                    np.asarray(jax.random.normal(n_rng, x0.shape, jnp.float32)))
             for name, (_, n, _) in LOSS_CASES.items()}

    def run(x0, x_T, y):
        out = {}
        for name, (obj, n, lab) in LOSS_CASES.items():
            pd = JPD.create(_chain(JGD, obj), n)
            out[name] = pd.distill_loss(_net(jnp, 0.3), _net(jnp, 0.5), key, x0,
                                        y=y if lab else None)
        for name, (steps, obj, clip) in SAMPLE_CASES.items():
            out[name] = j_pd_sample(_chain(JGD, obj), _net(jnp, 0.3), jax.random.PRNGKey(2), N,
                                    steps=steps, x_T=x_T, clip=clip).x
        return out

    out = jax.tree.map(np.asarray, jax.jit(run)(x0, x_T, y))
    return dict(x0=x0, x_T=x_T, y=y, draws=draws), out


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("t,n", [(50, 3), (50, 9), (1000, 5), (1000, 33)])
def test_grids_match_jax(t, n):
    assert np.array_equal(j_grid(t, n), t_grid(t, n))
    assert np.array_equal(np.asarray(JPD.create(JGD.create(timesteps=t), (n - 1) // 2 or 1)
                                     .grid()),
                          TPD.create(TGD.create(timesteps=t), (n - 1) // 2 or 1).grid())
    with pytest.raises(AssertionError, match="collides"):
        t_grid(4, 9)


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_distill_loss_matches_jax(ref, name):
    d, out = ref
    obj, n, lab = LOSS_CASES[name]
    k, eps = d["draws"][name]
    pd = TPD.create(_chain(TGD, obj), n)
    assert pd.student_process.objective == "v" and pd.teacher_process.objective == obj
    loss = pd.distill_loss(_net(torch, 0.3), _net(torch, 0.5), _t(d["x0"]),
                           y=_t(d["y"], torch.long) if lab else None, k=_t(k), noise=_t(eps))
    assert abs(float(loss) - float(out[name])) <= REL_TOL * abs(float(out[name]))


@pytest.mark.parametrize("name", sorted(SAMPLE_CASES))
def test_pd_sample_matches_jax(ref, name):
    d, out = ref
    steps, obj, clip = SAMPLE_CASES[name]
    x = t_pd_sample(_chain(TGD, obj), _net(torch, 0.3), N, device="cpu", steps=steps,
                    x_T=_t(d["x_T"]), clip=clip).x
    assert rel_err(x, out[name]) <= TRAJ_TOL


def test_the_student_carries_the_gradient_and_samples_its_round():
    w = torch.tensor(0.3, requires_grad=True)
    student = lambda x, t, c, y: w * x
    pd = TPD.create(_chain(TGD), 2, teacher_objective="v")
    loss = pd.distill_loss(student, _net(torch, 0.5), torch.zeros(2, SIZE, SIZE, 3),
                           generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert w.grad is not None and bool(torch.isfinite(w.grad))
    assert pd.sample(student, 2, device="cpu").x.shape == (2, SIZE, SIZE, 3)
