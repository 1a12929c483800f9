"""DPM-Solver++(2M) and (1M) sampling (Lu et al. 2022, arXiv:2211.01095), in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/dpm_solver.py``: a multistep
ODE solver over the diffusion probability flow in the data-prediction
formulation. With ``lambda_t = log(alpha_t / sigma_t)`` (alpha = sqrt(acp),
sigma = sqrt(1 - acp)) and x0-prediction ``D_i``::

    h_i   = lambda_{i+1} - lambda_i
    r_i   = h_{i-1} / h_i
    D~_i  = (1 + 1/(2 r_i)) D_i - 1/(2 r_i) D_{i-1}      (2nd order; D_i on step 0)
    x_i+1 = (sigma_{i+1} / sigma_i) x_i - alpha_{i+1} (exp(-h_i) - 1) D~_i

The step loop is a Python loop, x carried in float32 and the model input
cast to ``dtype``. The time tables come from :func:`solver_time_tables`:
the grid is chosen in float64 on the host, and the alphas, sigmas and
lambdas are gathered and logged in float32, as the JAX package does; the
per-step scalar coefficients are float32 too.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from eo_diffusion_torch.diffusion.gaussian import (
    DiffusionOutput,
    GaussianDiffusion,
    NoiseFn,
    _draw,
    apply_dynamic_threshold,
    call_guided,
    noise_level,
)

__all__ = ["dpm_solver_sample", "solver_time_tables"]

_F = np.float32


def solver_time_tables(sched, num_steps: int, time_spacing: str = "uniform_lambda"):
    """The S+1 discrete timesteps T-1 -> 0 of the solver grid and their
    float32 ``(alpha, sigma, lambda)`` (JAX ``solver_time_tables``).

    "uniform_lambda" spaces the targets uniformly in the half-log-SNR
    lambda; "uniform_t" is a DDIM-style stride; "karras" puts them on the
    rho-7 noise-to-signal curve of arXiv:2206.00364 eq. 5 (sigma_max capped
    at 80). Each target picks, greedily and strictly decreasing, the nearest
    trained timestep that leaves room for the steps still to come, so no
    step is an h = 0 no-op. Returns numpy ``(ts int32, alphas, sigmas,
    lambdas float32)``. Under a zero-terminal-SNR schedule alpha[T-1] is 0
    and only the 1e-20 clamp keeps lambda finite."""
    assert time_spacing in ("uniform_lambda", "uniform_t", "karras"), time_spacing
    T = sched.timesteps
    assert num_steps < T, (num_steps, T)
    if time_spacing == "uniform_t":
        ts = np.linspace(T - 1, 0, num_steps + 1).round().astype(np.int32)
    else:
        lam_all = (np.log(np.maximum(sched.sqrt_alphas_cumprod, 1e-20))
                   - np.log(np.maximum(sched.sqrt_one_minus_alphas_cumprod, 1e-20)))
        if time_spacing == "karras":
            rho = 7.0
            s_max = min(float(np.exp(-lam_all[T - 1])), 80.0)
            s_min = float(np.exp(-lam_all[0]))
            frac = np.linspace(0.0, 1.0, num_steps + 1)
            grid = (s_max ** (1 / rho) + frac * (s_min ** (1 / rho) - s_max ** (1 / rho))) ** rho
            targets = -np.log(grid)
        else:
            targets = np.linspace(lam_all[T - 1], lam_all[0], num_steps + 1)
        ts = np.empty(num_steps + 1, np.int32)
        ts[0], ts[-1] = T - 1, 0
        prev = T - 1
        for k in range(1, num_steps):
            cand = np.arange(num_steps - k, prev)
            ts[k] = prev = int(cand[np.argmin(np.abs(lam_all[cand] - targets[k]))])
    alphas = np.asarray(sched.sqrt_alphas_cumprod, _F)[ts]
    sigmas = np.asarray(sched.sqrt_one_minus_alphas_cumprod, _F)[ts]
    lambdas = np.log(np.maximum(alphas, _F(1e-20))) - np.log(np.maximum(sigmas, _F(1e-20)))
    return ts, alphas, sigmas, lambdas.astype(_F)


def dpm_solver_sample(diffusion: GaussianDiffusion, model_fn: Callable, n_samples: int, *,
                      device, generator: Optional[torch.Generator] = None,
                      num_steps: int = 20, order: int = 2,
                      cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                      x_T: Optional[torch.Tensor] = None, clip: bool = True,
                      dynamic_threshold=None, time_spacing: str = "uniform_lambda",
                      dtype: torch.dtype = torch.float32, model_state=None,
                      mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                      guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
                      guidance_interval=None, uncond=None, y_uncond=None,
                      noise_fn: Optional[NoiseFn] = None) -> DiffusionOutput:
    """Sample with DPM-Solver++(2M), or (1M) with ``order=1`` (DDIM at eta
    0 on the solver's grid); ``num_steps`` model calls (JAX
    ``dpm_solver_sample``).

    * ``clip`` clamps each x0 prediction to [-1, 1];
      ``dynamic_threshold`` (a percentile) rescales it instead.
    * ``mask``/``x0``: before each model call the known region (mask 1)
      is re-noised to the current level (``noise_fn(i, "mask")`` or the
      generator) and composited in; x0 is pasted in at the end.
    * CFG (``guidance_scale`` with ``uncond`` or ``y_uncond``,
      ``guidance_rescale``, ``guidance_interval`` at t / (T - 1)) and
      stateful denoisers (``model_state``, the state index the step)
      go through :func:`~eo_diffusion_torch.diffusion.gaussian.call_guided`.
    """
    assert order in (1, 2), order
    sched = diffusion.schedule
    T = sched.timesteps
    shape = (n_samples, diffusion.image_size, diffusion.image_size, diffusion.in_channels)
    t_seq, alphas, sigmas, lambdas = solver_time_tables(sched, num_steps, time_spacing)
    x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
         else torch.randn(shape, generator=generator, device=device))
    if mask is not None:
        assert x0 is not None, "DPM inpainting requires x0 (the known image)"
        mask, x0 = mask.float(), x0.float()
    state, d_prev = model_state, None
    for i in range(num_steps):
        t = torch.full((n_samples,), int(t_seq[i]), dtype=torch.long, device=device)
        if mask is not None:
            known = diffusion.q_sample(x0, t, _draw(noise_fn, generator, i, "mask", shape,
                                                    device))
            x = known * mask + (1.0 - mask) * x
        raw, state = call_guided(
            model_fn, x.to(dtype), t, cond, y, uncond=uncond, y_uncond=y_uncond,
            guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
            guidance_interval=guidance_interval,
            noise_frac=noise_level(int(t_seq[i]), max(T - 1, 1)),
            state=state, i=i)
        _, d_i = diffusion._to_eps_x0(raw, x, t)
        if clip or dynamic_threshold is not None:
            d_i = (apply_dynamic_threshold(d_i, dynamic_threshold)
                   if dynamic_threshold is not None else torch.clamp(d_i, -1.0, 1.0))
        h_i = lambdas[i + 1] - lambdas[i]
        d_tilde = d_i
        if order == 2 and i > 0:
            r = (lambdas[i] - lambdas[i - 1]) / (h_i if h_i != 0 else _F(1.0))
            coef = _F(1.0) / (_F(2.0) * (r if r != 0 else _F(1.0)))
            d_tilde = float(_F(1.0) + coef) * d_i - float(coef) * d_prev
        sig_ratio = sigmas[i + 1] / max(sigmas[i], _F(1e-20))
        step = alphas[i + 1] * (np.exp(-h_i) - _F(1.0))
        x = float(sig_ratio) * x - float(step) * d_tilde
        d_prev = d_i
    if mask is not None:
        x = x0 * mask + (1.0 - mask) * x
    return DiffusionOutput(x=x)
