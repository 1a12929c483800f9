"""The port's rectified-flow sampler (eo_diffusion_torch.diffusion.flow)
against the JAX package's ``FlowMatching.sample``, f32 on the CPU, from a
shared x_T: Euler and Heun on a closed-form velocity written in both
frameworks (with ``start_index`` and mask/x0 inpainting, the per-step draws
injected from the JAX package's), and one Heun trajectory through a tiny DiT
with class labels."""

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
from torch_parity import one_torch_thread, random_dit_params, rel_err  # noqa: F401

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


CASES = {  # method, num_steps, start_index, inpainting
    "euler": ("euler", 8, None, False),
    "heun": ("heun", 6, None, False),
    "heun_start_index": ("heun", 8, 3, False),
    "euler_mask": ("euler", 5, None, True),
    "heun_start_index_mask": ("heun", 6, 4, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_closed_form_trajectory_matches_jax(case):
    method, steps, start, inpaint = CASES[case]
    rng = np.random.default_rng(len(case))
    shape = (N, SIZE, SIZE, CH)
    x_T = rng.normal(size=shape).astype(np.float32)
    mask = x0 = None
    if inpaint:
        mask = (rng.uniform(size=(N, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
        x0 = rng.uniform(-1, 1, size=shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    j = JFM.create(image_size=SIZE, in_channels=CH)
    ref = j.sample(velocity_jax, key, N, num_steps=steps, method=method,
                   x_T=jnp.asarray(x_T), start_index=start,
                   mask=None if mask is None else jnp.asarray(mask),
                   x0=None if x0 is None else jnp.asarray(x0)).x
    noise = _mask_noise(key, steps, shape) if inpaint else None
    t = TFM.create(image_size=SIZE, in_channels=CH)
    out = t.sample(velocity_torch, N, device="cpu", num_steps=steps, method=method,
                   x_T=torch.from_numpy(x_T), start_index=start,
                   mask=None if mask is None else torch.from_numpy(mask),
                   x0=None if x0 is None else torch.from_numpy(x0),
                   noise_fn=(lambda i, role: torch.from_numpy(noise[i])) if inpaint else None).x
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
    t = TFM.create(image_size=SIZE, in_channels=CH)
    for kw in (dict(guidance_scale=2.0), dict(log_every=1), dict(model_state=0)):
        with pytest.raises(NotImplementedError, match="queue 11"):
            t.sample(velocity_torch, 1, device="cpu", num_steps=2, **kw)
    with pytest.raises(ValueError):
        t.sample(velocity_torch, 1, device="cpu", num_steps=2, method="rk4")
