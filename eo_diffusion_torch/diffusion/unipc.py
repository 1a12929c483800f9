"""UniPC, the unified predictor-corrector sampler (Zhao et al. 2023,
arXiv:2302.04867), multistep data-prediction variant, orders 1-3, in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/unipc.py``. Each step runs a
predictor (UniP) through the model-output history and a corrector (UniC)
that re-solves the step with the model output at its endpoint, the
evaluation the next predictor needs anyway: ``num_steps + 1`` model calls in
all. With lambda = log(alpha / sigma), h = lambda_next - lambda_cur and
x0-predictions m (the B2(h) = expm1(-h) variant)::

    phi1   = expm1(-h),  b1 = (phi1/(-h) - 1) / B_h,  b2 = ((phi1/(-h) - 1)/(-h) - 1/2) 2 / B_h
    r_k    = (lambda_k - lambda_cur) / h,   D1_k = (m_k - m_cur) / r_k
    x_next = (sigma_next/sigma_cur) x - alpha_next phi1 m_cur - alpha_next B_h sum_k rho_k D1_k

with rho solving the small Vandermonde system of the order in use; the order
ramps up over the first steps and down over the last ones, as the official
implementation does. The grid is exactly uniform in lambda
(:func:`continuous_time_tables`): the model sees fractional timesteps. The
step loop is a Python loop; the scalar coefficients are float32, as in the
JAX package, and x is carried in float32.
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

__all__ = ["unipc_sample", "continuous_time_tables"]

_F = np.float32


def continuous_time_tables(sched, num_steps: int):
    """The exactly lambda-uniform continuous-time grid (JAX
    ``continuous_time_tables``): S+1 lambda targets from lambda(T-1) to
    lambda(0), their fractional timesteps by monotone interpolation of the
    discrete lambda(t) table, and (alpha, sigma) from lambda through the VP
    identity alpha^2 = sigmoid(2 lambda). Returns float32 numpy ``(t,
    alphas, sigmas, lambdas)``."""
    T = sched.timesteps
    lam_all = (np.log(np.maximum(sched.sqrt_alphas_cumprod, 1e-20))
               - np.log(np.maximum(sched.sqrt_one_minus_alphas_cumprod, 1e-20)))
    targets = np.linspace(lam_all[T - 1], lam_all[0], num_steps + 1)
    t_cont = np.interp(targets, lam_all[::-1], np.arange(T - 1, -1, -1.0))
    alphas = np.sqrt(1.0 / (1.0 + np.exp(-2.0 * targets)))
    sigmas = np.sqrt(1.0 / (1.0 + np.exp(2.0 * targets)))
    return tuple(np.asarray(a, _F) for a in (t_cont, alphas, sigmas, targets))


def _two_term_rho(b1, b2, ra, rb):
    """Solve [[1, 1], [ra, rb]] rho = [b1, b2] (guarded 2x2 Vandermonde)."""
    den = _F(1.0) if rb == ra else rb - ra
    rho2 = (b2 - ra * b1) / den
    return b1 - rho2, rho2


def _three_term_rho(b1, b2, b3, ra, rb, rc):
    """Solve the 3x3 Vandermonde [[1, 1, 1], [ra, rb, rc], [ra^2, rb^2,
    rc^2]] rho = [b1, b2, b3] in float32."""
    rows = np.array([[1.0, 1.0, 1.0], [ra, rb, rc], [ra * ra, rb * rb, rc * rc]], _F)
    return tuple(_F(v) for v in np.linalg.solve(rows, np.array([b1, b2, b3], _F)))


def unipc_sample(diffusion: GaussianDiffusion, model_fn: Callable, n_samples: int, *,
                 device, generator: Optional[torch.Generator] = None,
                 num_steps: int = 10, order: int = 3,
                 cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                 x_T: Optional[torch.Tensor] = None, clip: bool = True,
                 dynamic_threshold=None, time_spacing: str = "uniform_lambda",
                 dtype: torch.dtype = torch.float32, model_state=None,
                 mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                 guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
                 guidance_interval=None, y_uncond=None, uncond=None,
                 noise_fn: Optional[NoiseFn] = None) -> DiffusionOutput:
    """Sample with multistep UniPC (JAX ``unipc_sample``): ``num_steps + 1``
    model calls.

    * The model sees the grid's fractional timesteps (float32 ``t``); its
      output converts to x0 with the node's exact (alpha, sigma), per
      ``diffusion.objective``. ``clip`` / ``dynamic_threshold`` as in
      :func:`~eo_diffusion_torch.diffusion.dpm_solver.dpm_solver_sample`.
    * ``mask``/``x0``: the known region is put on the node's marginal
      ``alpha x0 + sigma eps`` and composited in at every node, eps from
      ``noise_fn(k, "mask")`` for node k (or the generator); x0 is pasted
      in at the end.
    * CFG and stateful denoisers go through
      :func:`~eo_diffusion_torch.diffusion.gaussian.call_guided`; the state
      index counts model evaluations (0 for the first node's).
    """
    assert order in (1, 2, 3), order
    assert time_spacing == "uniform_lambda", (
        "UniPC runs on the exactly-lambda-uniform continuous-time grid "
        "(continuous_time_tables); other spacings are not offered")
    T = diffusion.schedule.timesteps
    shape = (n_samples, diffusion.image_size, diffusion.image_size, diffusion.in_channels)
    t_seq, alphas, sigmas, lambdas = continuous_time_tables(diffusion.schedule, num_steps)
    x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
         else torch.randn(shape, generator=generator, device=device))
    if mask is not None:
        assert x0 is not None, "UniPC inpainting requires x0 (known image)"
        mask, x0 = mask.float(), x0.float()
    state = model_state

    def predict_x0(xf, idx, eval_i):
        nonlocal state
        t = torch.full((n_samples,), float(t_seq[idx]), dtype=torch.float32, device=device)
        raw, state = call_guided(
            model_fn, xf.to(dtype), t, cond, y, uncond=uncond, y_uncond=y_uncond,
            guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
            guidance_interval=guidance_interval,
            noise_frac=noise_level(t_seq[idx], max(T - 1, 1)),
            state=state, i=eval_i)
        raw = raw.float()
        a, s = float(max(alphas[idx], _F(1e-8))), float(sigmas[idx])
        if diffusion.objective == "eps":
            d = xf / a - float(_F(s) / _F(a)) * raw
        elif diffusion.objective == "x0":
            d = raw
        else:  # "v"
            d = a * xf - s * raw
        if clip or dynamic_threshold is not None:
            d = (apply_dynamic_threshold(d, dynamic_threshold)
                 if dynamic_threshold is not None else torch.clamp(d, -1.0, 1.0))
        return d

    def composite(xf, idx):
        if mask is None:
            return xf
        eps = _draw(noise_fn, generator, idx, "mask", shape, device)
        known = float(alphas[idx]) * x0 + float(sigmas[idx]) * eps
        return known * mask + (1.0 - mask) * xf

    x = composite(x, 0)
    m_c = predict_x0(x, 0, 0)
    m_p = m_p2 = torch.zeros_like(m_c)
    one = _F(1.0)
    for i in range(num_steps):
        h = lambdas[i + 1] - lambdas[i]
        h_safe = one if h == 0 else h
        hh = -h
        hh_safe = _F(-1.0) if hh == 0 else hh
        phi1 = np.expm1(hh)  # e^-h - 1, the B2(h) variant's B_h too
        b_h_safe = one if phi1 == 0 else phi1
        k1 = phi1 / hh_safe - one
        b1 = k1 / b_h_safe
        k2 = k1 / hh_safe - _F(0.5)
        b2 = k2 * _F(2.0) / b_h_safe
        k3 = k2 / hh_safe - _F(1.0 / 6.0)
        b3 = k3 * _F(6.0) / b_h_safe
        sig_ratio = sigmas[i + 1] / max(sigmas[i], _F(1e-20))
        a_n = alphas[i + 1]
        base = float(sig_ratio) * x - float(a_n * phi1) * m_c

        # history ratios (negative), guarded for the ramp-up steps
        r1 = (lambdas[max(i - 1, 0)] - lambdas[i]) / h_safe if i >= 1 else _F(-1.0)
        r2 = (lambdas[max(i - 2, 0)] - lambdas[i]) / h_safe if i >= 2 else _F(-2.0)
        r1 = _F(-1.0) if r1 == 0 else r1
        r2 = r1 - one if r2 == r1 else r2
        d11 = (m_p - m_c) / float(r1)
        d12 = (m_p2 - m_c) / float(r2)
        # the order ramps up with the history and down over the last steps
        cap = min(order, num_steps - i)

        # predictor: order 2 takes the official weight 1/2, order 3 the 2x2 system
        rho1 = rho2 = _F(0.0)
        if i >= 2 and cap >= 3:
            rho1, rho2 = _two_term_rho(b1, b2, r1, r2)
        elif i >= 1 and cap >= 2:
            rho1 = _F(0.5)
        scale = float(a_n * phi1)
        x_pred = base - scale * (float(rho1) * d11 + float(rho2) * d12)

        # corrector: the endpoint evaluation joins the system at r = 1
        m_n = predict_x0(x_pred, i + 1, i + 1)
        d1n = m_n - m_c
        if i >= 2 and cap >= 3:
            c1, c2, cn = _three_term_rho(b1, b2, b3, r1, r2, one)
        elif i >= 1 and cap >= 2:
            (c1, cn), c2 = _two_term_rho(b1, b2, r1, one), _F(0.0)
        else:
            c1, c2, cn = _F(0.0), _F(0.0), _F(0.5)
        x = base - scale * (float(c1) * d11 + float(c2) * d12 + float(cn) * d1n)
        x = composite(x, i + 1)
        m_p2, m_p, m_c = m_p, m_c, m_n
    if mask is not None:
        x = x0 * mask + (1.0 - mask) * x
    return DiffusionOutput(x=x)
