"""The port's rectified-flow sampler (eo_diffusion_torch.diffusion.flow)
against the JAX package's ``FlowMatching.sample``, f32 on the CPU, from a
shared x_T: Euler and Heun on a closed-form velocity written in both
frameworks (with ``start_index`` and mask/x0 inpainting, the per-step draws
injected from the JAX package's), the same integrators with image- and
label-CFG (rescale, interval) and a stateful denoiser on a closed-form
denoiser, and one Heun trajectory through a tiny DiT with class labels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion.flow import FlowMatching as TFM
from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params
from eo_diffusion_tpu.diffusion.flow import FlowMatching as JFM
from eo_diffusion_tpu.models import dit as JD
from torch_parity import (cached_denoiser, closed_form_denoiser, one_torch_thread,  # noqa: F401
                          random_dit_params, rel_err)

# trajectory rel err max |torch - jax| / max |jax| (DESIGN.md:52-54)
TRAJ_TOL = 5e-5
SIZE, CH, N = 8, 3, 2


def velocity_jax(x, t, cond=None, y=None):
    return 0.7 * x + jnp.sin(x) * (t / 1000.0)[:, None, None, None] - 0.1


def velocity_torch(x, t, cond=None, y=None):
    return 0.7 * x + torch.sin(x) * (t / 1000.0)[:, None, None, None] - 0.1


def _mask_noise(rng, steps, shape):
    """The JAX sampler's per-step inpainting draws (``fold_in(mask_rng, i)``)."""
    mask_rng = jax.random.fold_in(rng, 7)
    return [np.array(jax.random.normal(jax.random.fold_in(mask_rng, i), shape, jnp.float32))
            for i in range(steps)]


CASES = {  # method, num_steps, start_index, inpainting, guidance, stateful
    "euler": ("euler", 8, None, False, None, False),
    "heun": ("heun", 6, None, False, None, False),
    "heun_start_index": ("heun", 8, 3, False, None, False),
    "euler_mask": ("euler", 5, None, True, None, False),
    "heun_start_index_mask": ("heun", 6, 4, True, None, False),
    # CFG on the closed-form denoiser of torch_parity: the interval is
    # decided at each call's ODE time, the Heun second call's at t_next
    "euler_image_cfg_rescale_interval": ("euler", 6, None, False, "image", False),
    "heun_image_cfg_rescale_interval_state": ("heun", 5, None, False, "image", True),
    "heun_label_cfg_interval_state_mask": ("heun", 4, None, True, "label", True),
}
# image-CFG against a zero cloudy view, label-CFG against the null class 4
GUIDANCE = {
    "image": dict(guidance_scale=3.0, guidance_rescale=0.7, guidance_interval=(0.2, 0.8)),
    "label": dict(guidance_scale=2.0, guidance_rescale=0.5, guidance_interval=(0.3, 1.0)),
}


def _guidance(guide, rng, shape):
    """The guidance keywords of a case, as numpy arrays, and the model's."""
    if guide is None:
        return {}
    kw = dict(GUIDANCE[guide])
    if guide == "image":
        kw.update(cond=rng.uniform(-1, 1, size=shape).astype(np.float32),
                  uncond=np.zeros(shape, np.float32))
    else:
        kw.update(y=np.array([0, 2], np.int32), y_uncond=np.array([4, 4], np.int32))
    return kw


def _case(case):
    """A case's x_T, mask, x0 and guidance keywords (numpy) and its velocity
    for each library."""
    _, _, _, inpaint, guide, stateful = CASES[case]
    rng = np.random.default_rng(len(case))
    shape = (N, SIZE, SIZE, CH)
    x_T = rng.normal(size=shape).astype(np.float32)
    mask = x0 = None
    if inpaint:
        mask = (rng.uniform(size=(N, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
        x0 = rng.uniform(-1, 1, size=shape).astype(np.float32)
    gkw = _guidance(guide, rng, shape)
    fns = {jnp: velocity_jax, torch: velocity_torch}
    if guide is not None:
        fns = {lib: (cached_denoiser(lib) if stateful else closed_form_denoiser(lib))
               for lib in (jnp, torch)}
    if stateful:  # the state has the doubled batch's shape
        gkw["model_state"] = np.zeros((2 * N,) + shape[1:], np.float32)
    return x_T, mask, x0, gkw, fns


@pytest.fixture(scope="module")
def jax_trajectories():
    """Every case's JAX trajectory from one jitted function (one compile)."""
    as_j = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a

    @jax.jit
    def run():
        out = {}
        for case, (method, steps, start, *_) in CASES.items():
            x_T, mask, x0, gkw, fns = _case(case)
            out[case] = JFM.create(image_size=SIZE, in_channels=CH).sample(
                fns[jnp], jax.random.PRNGKey(3), N, num_steps=steps, method=method,
                x_T=jnp.asarray(x_T), start_index=start, mask=as_j(mask), x0=as_j(x0),
                **{k: as_j(v) for k, v in gkw.items()}).x
        return out

    return {k: np.asarray(v) for k, v in run().items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_closed_form_trajectory_matches_jax(jax_trajectories, case):
    method, steps, start, inpaint, guide, stateful = CASES[case]
    shape = (N, SIZE, SIZE, CH)
    x_T, mask, x0, gkw, fns = _case(case)
    as_t = lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    key = jax.random.PRNGKey(3)
    ref = jax_trajectories[case]
    noise = _mask_noise(key, steps, shape) if inpaint else None
    t = TFM.create(image_size=SIZE, in_channels=CH)
    out = t.sample(fns[torch], N, device="cpu", num_steps=steps, method=method,
                   x_T=torch.from_numpy(x_T), start_index=start,
                   mask=None if mask is None else torch.from_numpy(mask),
                   x0=None if x0 is None else torch.from_numpy(x0),
                   noise_fn=(lambda i, role: torch.from_numpy(noise[i])) if inpaint else None,
                   **{k: as_t(v) for k, v in gkw.items()}).x
    assert out.dtype == torch.float32 and out.shape == shape
    assert rel_err(out, ref) <= TRAJ_TOL
    if inpaint:  # the final paste keeps the known pixels verbatim
        known = np.broadcast_to(mask, shape) > 0
        np.testing.assert_array_equal(out.numpy()[known], x0[known])


def test_dit_heun_trajectory_matches_jax():
    kw = dict(image_size=16, in_channels=3, out_channels=3, patch_size=4, hidden_size=64,
              depth=2, num_heads=4, num_classes=3)
    jcfg, tcfg = JD.DiTConfig(**kw), TD.DiTConfig(**kw)
    jmodel, params = random_dit_params(jcfg, seed=7)
    rng = np.random.default_rng(2)
    x_T = (0.5 * rng.normal(size=(N, 16, 16, 3))).astype(np.float32)
    y = np.array([2, 0], np.int32)
    ref = JFM.create(image_size=16, in_channels=3).sample(
        lambda x, t, c, yy: jmodel.apply(params, x, t, cond=c, y=yy), jax.random.PRNGKey(0), N,
        num_steps=3, method="heun", y=jnp.asarray(y), x_T=jnp.asarray(x_T)).x
    model = TD.DiT(tcfg)
    model.load_state_dict(dit_state_dict_from_jax_params(params, tcfg), strict=True)
    calls = []

    def model_fn(x, t, c, yy):
        calls.append(float(t[0]))
        return model(x, t, cond=c, y=yy)

    with torch.no_grad():
        out = TFM.create(image_size=16, in_channels=3).sample(
            model_fn, N, device="cpu", num_steps=3, method="heun",
            y=torch.from_numpy(y).long(), x_T=torch.from_numpy(x_T)).x
    # Heun: two calls an interval, one on the last (an Euler step to t = 0)
    np.testing.assert_allclose(calls, [1000, 2000 / 3, 2000 / 3, 1000 / 3, 1000 / 3], rtol=1e-6)
    assert rel_err(out, ref) <= TRAJ_TOL


def test_unported_options_raise():
    """``log_every`` frames come back (one a step, the last the result);
    guidance without an unconditional branch is the plain sample, and a
    stateful velocity (``model_state``) sees every step's index, twice a Heun
    step."""
    t = TFM.create(image_size=SIZE, in_channels=CH)
    framed = t.sample(velocity_torch, 1, device="cpu", num_steps=2, log_every=1)
    assert framed.intermediates.shape == (2, 1, SIZE, SIZE, CH)
    assert torch.equal(framed.intermediates[-1], framed.x)
    x_T = torch.randn(1, SIZE, SIZE, CH, generator=torch.Generator().manual_seed(0))
    plain = t.sample(velocity_torch, 1, device="cpu", num_steps=3, x_T=x_T).x
    unguided = t.sample(velocity_torch, 1, device="cpu", num_steps=3, x_T=x_T,
                        guidance_scale=2.0).x
    torch.testing.assert_close(unguided, plain, rtol=0, atol=0)
    seen = []
    stateful = lambda x, tt, c, y, st, i: (seen.append(i) or velocity_torch(x, tt), st + 1)
    out = t.sample(stateful, 1, device="cpu", num_steps=3, x_T=x_T, method="heun",
                   model_state=0).x
    assert seen == [0, 0, 1, 1, 2]
    heun = t.sample(velocity_torch, 1, device="cpu", num_steps=3, x_T=x_T, method="heun").x
    torch.testing.assert_close(out, heun, rtol=0, atol=0)
    with pytest.raises(ValueError):
        t.sample(velocity_torch, 1, device="cpu", num_steps=2, method="rk4")
