"""EDM: the Karras et al. 2022 diffusion formulation, in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/edm.py`` ("Elucidating the Design
Space of Diffusion-Based Generative Models", arXiv:2206.00364). The process
lives in sigma space with a preconditioned denoiser

    D(x; sigma) = c_skip(sigma) x + c_out(sigma) F(c_in(sigma) x, c_noise)

    c_skip = sd^2/(sigma^2+sd^2)      c_out = sigma sd / sqrt(sigma^2+sd^2)
    c_in   = 1/sqrt(sigma^2+sd^2)     c_noise = ln(sigma)/4

trained at log-normal noise levels and sampled on the rho-warped Karras grid
with Heun steps (the last step into sigma 0 an Euler step) and optional
churn. ``lambda(sigma) c_out(sigma)^2 = 1``, so the weighted EDM loss is a
plain MSE of the raw network output against ``(x0 - c_skip x_t) / c_out``.

The model sees ``t_model = ln(sigma)/4 * time_scale``, a float that is
negative below sigma 1 (about -388 at sigma_min); the sinusoidal timestep
embedding takes it as it is.

x is carried in float32 and only the model input is cast to ``dtype``. The
Karras grid is built on the host in float32 as the JAX package builds it
(:func:`karras_sigmas`), and the per-step scalars stay float32. Random
draws come from an explicit ``torch.Generator``; ``noise_fn(i, "mask" |
"churn")`` replaces step ``i``'s inpainting or churn draw, so tests can feed
the JAX package's. Classifier-free guidance (image and label, rescale, the
interval at ``sigma / sigma_max``) and stateful denoisers (``model_state``,
DeepCache) go through the guidance points of ``diffusion/gaussian.py``;
``log_every=k`` keeps the x after every k-th step. All tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from eo_diffusion_torch.diffusion.gaussian import (DenoiseFn, DiffusionOutput, NoiseFn, _draw,
                                                   call_guided, log_frames, noise_level,
                                                   stack_frames)

__all__ = ["EDMProcess", "karras_sigmas"]


def karras_sigmas(num_steps: int, sigma_min: float, sigma_max: float,
                  rho: float) -> np.ndarray:
    """The rho-warped sigma grid (arXiv:2206.00364 eq. 5), descending, with
    the terminal 0 appended: ``[num_steps + 1]`` float32, as the JAX
    package's ``karras_sigmas`` computes it: ``(hi + i / max(n - 1, 1) *
    (lo - hi)) ** rho`` in float32, ``lo`` and ``hi`` the float64 roots
    ``sigma ** (1 / rho)`` rounded once. A float64 grid parts from it in the
    last bit, which can move the guidance interval's gate where a level lies
    on its edge."""
    i = np.arange(num_steps, dtype=np.float32)
    lo, hi = sigma_min ** (1.0 / rho), sigma_max ** (1.0 / rho)
    base = np.float32(hi) + i / np.float32(max(num_steps - 1, 1)) * np.float32(lo - hi)
    return np.concatenate([base ** np.float32(rho), np.zeros(1, np.float32)])


@dataclasses.dataclass(frozen=True)
class EDMProcess:
    """Sigma-space diffusion with EDM preconditioning."""

    image_size: int
    in_channels: int
    cond_type: Optional[str] = None  # None | "concat" | "sum" (sampling-time inpainting)
    sigma_data: float = 0.5
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    # the training sigmas: ln(sigma) ~ N(p_mean, p_std^2) (table 1)
    p_mean: float = -1.2
    p_std: float = 1.2
    # the model sees c_noise * time_scale: ln(sigma)/4 spans about [-1.6, 1.1]
    # over [sigma_min, sigma_max], which 250 spreads over the range the
    # sinusoidal embedding resolves
    time_scale: float = 250.0

    @classmethod
    def create(cls, image_size: int = 64, in_channels: int = 3,
               cond_type: Optional[str] = None, **kw) -> "EDMProcess":
        return cls(image_size=image_size, in_channels=in_channels, cond_type=cond_type, **kw)

    # -- preconditioning ------------------------------------------------------

    def _coeffs(self, sigma: torch.Tensor):
        """``(c_skip, c_in, c_out, t_model)`` for per-sample sigma ``[N]``,
        float32. The denominator ``sigma^2 + sd^2`` is float32 as in JAX; its
        rsqrt is taken in float64 and rounded once, since float32 rsqrts part
        in the last bit (XLA's and torch's each lie an ulp from the correctly
        rounded value, on either side)."""
        sigma = sigma.float()
        sd2 = self.sigma_data ** 2
        den = sigma ** 2 + sd2
        r = torch.rsqrt(den.double())
        c_skip = sd2 / den
        c_out = (sigma.double() * self.sigma_data * r).float()
        c_in = r.float()
        t_model = torch.log(torch.clamp(sigma, min=1e-20)) / 4.0 * self.time_scale
        return c_skip, c_in, c_out, t_model

    # -- training -------------------------------------------------------------

    def training_tuple(self, x0: torch.Tensor, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       sigma: Optional[torch.Tensor] = None):
        """One training instance ``(x_model_in, t_model, target)`` with ``loss
        = mean((model(x_model_in, t_model) - target)^2)``: the input ``c_in
        x_t`` in x0's dtype, ``t_model`` and the target ``(x0 - c_skip x_t) /
        c_out`` in float32. sigma is drawn before eps; ``sigma`` and
        ``noise`` replace the draws."""
        n = x0.shape[0]
        if sigma is None:
            z = torch.randn(n, generator=generator, device=x0.device)
            sigma = torch.exp(self.p_mean + self.p_std * z)
        sigma = sigma.to(device=x0.device, dtype=torch.float32)
        eps = (noise.to(device=x0.device, dtype=torch.float32) if noise is not None
               else torch.randn(x0.shape, generator=generator, device=x0.device))
        x0f = x0.float()
        x_t = x0f + sigma[:, None, None, None] * eps
        c_skip, c_in, c_out, t_model = self._coeffs(sigma)
        cb = lambda v: v[:, None, None, None]
        target = (x0f - cb(c_skip) * x_t) / cb(c_out)
        return (cb(c_in) * x_t).to(x0.dtype), t_model, target

    def train_loss(self, model_fn: DenoiseFn, x0: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The preconditioned MSE in float32 (JAX ``EDMProcess.train_loss``,
        ``diffusion/edm.py:131``); ``t`` is the noise level sigma ``[N]``,
        replacing the log-normal draw."""
        x_in, t_model, target = self.training_tuple(x0, generator, noise, t)
        pred = model_fn(x_in, t_model, cond, y)
        return ((pred.float() - target) ** 2).mean()

    # -- sampling -------------------------------------------------------------

    def sample(self, model_fn: DenoiseFn, n_samples: int, *, device,
               generator: Optional[torch.Generator] = None, num_steps: int = 18,
               method: str = "heun", cond: Optional[torch.Tensor] = None,
               y: Optional[torch.Tensor] = None, x_T: Optional[torch.Tensor] = None,
               guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
               guidance_interval=None, uncond=None, y_uncond=None,
               mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
               log_every=None, dtype: torch.dtype = torch.float32, model_state=None,
               s_churn: float = 0.0, s_noise: float = 1.0, s_tmin: float = 0.05,
               s_tmax: float = 50.0, noise_fn: Optional[NoiseFn] = None) -> DiffusionOutput:
        """Algorithm 2 of arXiv:2206.00364 (JAX ``EDMProcess.sample``,
        ``diffusion/edm.py:138-256``).

        * Heun steps on the Karras grid (:func:`karras_sigmas`): two model
          calls a step, except the last step into sigma 0, an Euler step
          with one call (``method="euler"``: one call every step).
        * ``s_churn > 0``: inside ``[s_tmin, s_tmax]`` the level is raised to
          ``sigma (1 + gamma)`` with ``gamma = min(s_churn / num_steps,
          sqrt(2) - 1)`` and fresh noise (``noise_fn(i, "churn")``) added.
        * ``mask``/``x0``: before each step the known region (mask 1) is put
          back at ``x0 + sigma eps`` with a fresh eps (``noise_fn(i,
          "mask")``), and after the last step x0 is pasted in.
        * ``guidance_scale`` with ``uncond`` or ``y_uncond``,
          ``guidance_rescale`` and ``guidance_interval`` (the level is
          ``sigma / sigma_max``): the raw outputs are combined, which combines
          the denoised values since D is affine in F.
        * ``model_state``: a stateful denoiser ``fn(x, t, cond, y, state, i)
          -> (out, state)``; both Heun calls of step ``i`` pass ``i``.
        * ``x_T`` replaces the starting noise ``sigma_max * N(0, 1)``.
        """
        if method not in ("euler", "heun"):
            raise ValueError(f"method must be 'euler' or 'heun', got {method!r}")
        if mask is not None:
            assert x0 is not None, "EDM inpainting requires x0 (known image)"
            mask, x0 = mask.float(), x0.float()
        shape = (n_samples, self.image_size, self.image_size, self.in_channels)
        sigmas = karras_sigmas(num_steps, self.sigma_min, self.sigma_max, self.rho)
        x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
             else float(sigmas[0]) * torch.randn(shape, generator=generator, device=device))
        state = model_state
        cb = lambda v: v[:, None, None, None]

        def denoise(xx: torch.Tensor, sig: np.float32, i: int) -> torch.Tensor:
            """D(x; sigma) through the preconditioned network, CFG-combined."""
            nonlocal state
            s = torch.full((n_samples,), float(sig), dtype=torch.float32, device=device)
            c_skip, c_in, c_out, t_model = self._coeffs(s)
            out, state = call_guided(
                model_fn, (cb(c_in) * xx).to(dtype), t_model, cond, y, uncond=uncond,
                y_uncond=y_uncond, guidance_scale=guidance_scale,
                guidance_rescale=guidance_rescale, guidance_interval=guidance_interval,
                noise_frac=noise_level(sig, self.sigma_max), state=state, i=i)
            return cb(c_skip) * xx + cb(c_out) * out.float()

        churn = np.float32(min(s_churn / num_steps, float(np.sqrt(np.float32(2.0))) - 1.0))
        frames = []
        for i in range(num_steps):
            sig, sig_next = sigmas[i], sigmas[i + 1]
            if mask is not None:
                eps = _draw(noise_fn, generator, i, "mask", shape, device)
                x = mask * (x0 + float(sig) * eps) + (1.0 - mask) * x
            sig_hat = sig
            if s_churn > 0.0:
                gamma = churn if s_tmin <= sig <= s_tmax else np.float32(0.0)
                sig_hat = sig * (np.float32(1.0) + gamma)
                dn = _draw(noise_fn, generator, i, "churn", shape, device)
                lift = np.sqrt(max(sig_hat * sig_hat - sig * sig, np.float32(0.0)))
                x = x + float(lift) * s_noise * dn
            d1 = (x - denoise(x, sig_hat, i)) / float(max(sig_hat, np.float32(1e-20)))
            dt = float(sig_next - sig_hat)
            x_euler = x + dt * d1
            if method == "heun" and i < num_steps - 1:
                d2 = ((x_euler - denoise(x_euler, sig_next, i))
                      / float(max(sig_next, np.float32(1e-20))))
                x = x + dt * 0.5 * (d1 + d2)
            else:
                x = x_euler
            log_frames(frames, x, i, log_every, dtype)
        if mask is not None:
            x = mask * x0 + (1.0 - mask) * x
        return DiffusionOutput(x=x, intermediates=stack_frames(frames))
