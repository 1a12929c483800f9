"""Autoguidance: guide a diffusion model with a worse version of itself
(Karras et al. 2024, arXiv:2406.02507), in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/autoguide.py``:
``D = D_bad + w (D_main - D_bad)`` with w > 1, where the bad model is an
earlier checkpoint or a short-EMA synthesis from the post-hoc EMA snapshots
(``train/posthoc_ema.py``). It needs no condition, so it works on the
unconditional EO presets where CFG has no null branch. It is a denoiser
wrapper: every sampler takes it as its ``model_fn``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from eo_diffusion_torch.diffusion.gaussian import guided_combine, interval_scale, noise_level

__all__ = ["autoguided_model_fn"]


def autoguided_model_fn(fn_main: Callable, fn_bad: Callable, scale: float,
                        guidance_rescale: float = 0.0,
                        guidance_interval: Optional[Tuple[float, float]] = None,
                        timesteps: int = 1000,
                        noise_frac_fn: Optional[Callable] = None) -> Callable:
    """Wrap two denoisers ``(x, t, cond, y) -> pred`` (the same
    parameterization) into the autoguided one, in float32 (JAX
    ``autoguided_model_fn``). ``guidance_rescale`` and ``guidance_interval``
    mirror the CFG combine's. The interval gate needs the normalized noise
    level, but the wrapper sees only the model's ``t``: ``noise_frac_fn(t)``
    inverts it (``t[0] / time_scale`` on the flow ODE); the default ``t[0] /
    (timesteps - 1)`` holds on the DDPM chain. The gate is decided on the
    device (a tensor ``t``), so it adds no host sync."""
    assert scale >= 1.0, scale

    def fn(x, t, cond=None, y=None):
        e_m = fn_main(x, t, cond, y).float()
        e_b = fn_bad(x, t, cond, y).float()
        frac = (noise_frac_fn(t) if noise_frac_fn is not None
                else noise_level(t[0], max(timesteps - 1, 1)))
        eff = interval_scale(scale, frac, guidance_interval)
        return guided_combine(e_b, e_m, eff, guidance_rescale)

    return fn
