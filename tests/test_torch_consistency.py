"""Consistency distillation in the port (eo_diffusion_torch.diffusion.consistency)
against the JAX package's ``ConsistencyDistillation``, float32 on the CPU:
the grid, the boundary coefficients, the loss (a teacher's DDIM step,
consistency training without a teacher, pseudo-Huber) with the JAX draws of
the grid positions and eps injected, the slow-EMA ``update_target``, and the
``cm`` sampler's trajectories at 1-4 steps with the JAX hop noise injected.
Student, target and teacher are closed-form denoisers (eps, x0 and v
teachers), so the one jitted JAX function compiles no network."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion.consistency import ConsistencyDistillation as TCD
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_tpu.diffusion.consistency import ConsistencyDistillation as JCD
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from torch_parity import one_torch_thread, rel_err  # noqa: F401

REL_TOL = 1e-5   # losses, coefficients, update_target
TRAJ_TOL = 5e-5  # sampler trajectories
N, SIZE, T = 3, 8, 50
LOSS_CASES = {  # teacher objective (None: consistency training), huber c, cond/label
    "eps_teacher": ("eps", 0.0, False),
    "v_teacher_huber": ("v", 0.03, False),
    "x0_teacher_label": ("x0", 0.0, True),
    "no_teacher": (None, 0.0, False),
}
KW = dict(n_points=9, sigma_data=0.5)


def _net(lib, a):
    """A closed-form denoiser; ``a`` tells student, target and teacher apart."""
    def fn(x, t, c=None, y=None):
        tt = (t.astype(jnp.float32) if lib is jnp else t.float()) / T
        out = a * x + lib.sin(x) * tt[:, None, None, None] - 0.05
        if y is not None:
            yy = y.astype(jnp.float32) if lib is jnp else y.float()
            out = out + 0.1 * yy[:, None, None, None] * (1.0 + 0.5 * x)
        return out
    return fn


def _jax_cd(objective="eps", **kw):
    return JCD.create(JGD.create(timesteps=T, image_size=SIZE, in_channels=3,
                                 objective=objective), **{**KW, **kw})


def _port_cd(objective="eps", **kw):
    return TCD.create(TGD.create(timesteps=T, image_size=SIZE, in_channels=3,
                                 objective=objective), **{**KW, **kw})


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(0)
    x0 = np.clip(rng.normal(size=(N, SIZE, SIZE, 3)), -1, 1).astype(np.float32)
    x_T = rng.normal(size=(N, SIZE, SIZE, 3)).astype(np.float32)
    y = np.array([0, 1, 2], np.int32)
    trees = [{"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}} for _ in range(2)]
    key = jax.random.PRNGKey(3)
    i_rng, n_rng = jax.random.split(key)
    idx = np.asarray(jax.random.randint(i_rng, (N,), 0, KW["n_points"] - 1))
    eps = np.asarray(jax.random.normal(n_rng, x0.shape, jnp.float32))
    _, hop_rng = jax.random.split(jax.random.PRNGKey(9))
    hops = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(hop_rng, j),
                                                  x0.shape, jnp.float32)) for j in range(3)])

    def run(x0, x_T, y, trees):
        out = {"coeffs": _jax_cd()._coeffs(jnp.arange(T))}
        for name, (obj, huber, lab) in LOSS_CASES.items():
            cd = _jax_cd(obj or "eps", huber_c=huber)
            out[name] = cd.distill_loss(_net(jnp, 0.6), _net(jnp, 0.55),
                                        None if obj is None else _net(jnp, 0.5), key, x0,
                                        y=y if lab else None)
        out["target"] = JCD.update_target(trees[0], trees[1], 0.9)
        for steps in (1, 2, 3, 4):
            out[f"cm{steps}"] = _jax_cd().sample(_net(jnp, 0.6), jax.random.PRNGKey(9), N,
                                                 steps=steps, x_T=x_T).x
        return out

    out = jax.tree.map(np.asarray, jax.jit(run)(x0, x_T, y, trees))
    return dict(x0=x0, x_T=x_T, y=y, trees=trees, idx=idx, eps=eps, hops=hops), out


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("t,n", [(50, 9), (1000, 18), (1000, 40), (250, 7)])
def test_grid_matches_jax(t, n):
    jgrid = JCD.create(JGD.create(timesteps=t), n_points=n).grid()
    tgrid = TCD.create(TGD.create(timesteps=t), n_points=n).grid()
    assert np.array_equal(np.asarray(jgrid), tgrid)


def test_coefficients_match_jax(ref):
    _, out = ref
    for got, want in zip(_port_cd()._coeffs(torch.arange(T)), out["coeffs"]):
        assert rel_err(got, want) <= REL_TOL
    c_skip, c_out, _ = _port_cd()._coeffs(torch.tensor([0]))
    assert abs(float(c_skip) - 1.0) < 1e-2 and float(c_out) < 0.05  # f(x, 0) ~ x


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_distill_loss_matches_jax(ref, name):
    d, out = ref
    obj, huber, lab = LOSS_CASES[name]
    loss = _port_cd(obj or "eps", huber_c=huber).distill_loss(
        _net(torch, 0.6), _net(torch, 0.55), None if obj is None else _net(torch, 0.5),
        _t(d["x0"]), y=_t(d["y"], torch.long) if lab else None, idx=_t(d["idx"]),
        noise=_t(d["eps"]))
    assert abs(float(loss) - float(out[name])) <= REL_TOL * abs(float(out[name]))


def test_update_target_matches_jax(ref):
    d, out = ref
    leaves = lambda tree: [tree["a"], tree["b"]["c"]]
    target = [_t(a) for a in leaves(d["trees"][0])]
    TCD.update_target(target, [_t(a) for a in leaves(d["trees"][1])], 0.9)
    for got, want in zip(target, leaves(out["target"])):
        assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("steps", [1, 2, 3, 4])
def test_cm_sampler_matches_jax(ref, steps):
    d, out = ref
    x = _port_cd().sample(_net(torch, 0.6), N, device="cpu", steps=steps, x_T=_t(d["x_T"]),
                          noise_fn=lambda j, role: _t(d["hops"][j])).x
    assert rel_err(x, out[f"cm{steps}"]) <= TRAJ_TOL


def test_the_loss_draws_itself_and_carries_the_students_gradient():
    w = torch.tensor(0.6, requires_grad=True)
    student = lambda x, t, c, y: w * x + 0.1
    frozen = lambda x, t, c, y: 0.55 * x
    loss = _port_cd().distill_loss(student, frozen, frozen, torch.zeros(2, SIZE, SIZE, 3),
                                   generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert loss.ndim == 0 and w.grad is not None and bool(torch.isfinite(w.grad))
