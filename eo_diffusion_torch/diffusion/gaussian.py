"""Gaussian diffusion: DDPM (with RePaint) and DDIM samplers in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/gaussian.py`` on the sampling
path:

* ``EODiffusion`` (reference ``diffusion/model.py:12-150``): cosine-beta
  DDPM, ancestral sampling with optional x0 clipping and RePaint-"sum"
  masked conditioning (``model.py:58-60``), plus RePaint jumps
  (arXiv:2201.09865);
* ``DDIMSampler`` (reference ``diffusion/ddim.py:11-207``): strided
  deterministic / eta-stochastic sampling with mask inpainting.

The reverse loops are plain Python loops over the steps. x_t is carried in
float32 and only the model input is cast to ``dtype`` (per-step bf16
rounding accumulates over the chain). Random draws come from an explicit
``torch.Generator``; ``noise_fn(i, role)`` replaces them, so tests can feed
the JAX package's noise. All tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from eo_diffusion_torch.core.schedules import (
    DDIMSchedule,
    DiffusionSchedule,
    make_ddim_schedule,
    make_schedule,
)

__all__ = ["GaussianDiffusion", "DiffusionOutput", "repaint_op_sequence"]

# A denoiser: (x_t [N,H,W,C], t [N], cond, y) -> model output [N,H,W,C].
DenoiseFn = Callable[..., torch.Tensor]
# Noise hook: (step index, role) -> a standard-normal tensor of the image shape.
NoiseFn = Callable[[int, str], torch.Tensor]


def repaint_op_sequence(timesteps: int, jump_len: int, jump_n: int):
    """RePaint resampling trajectory (Lugmayr et al. 2022, arXiv:2201.09865,
    Alg. 2). Returns numpy ``(t_ops, is_reverse)``: at op ``k``,
    ``is_reverse[k] == 1`` is an ancestral reverse step at level ``t_ops[k]``
    and ``0`` one forward q-step *to* level ``t_ops[k]``. ``jump_n=1`` is the
    reference's jump-free composite."""
    assert jump_len >= 1 and jump_n >= 1, (jump_len, jump_n)
    jumps = {j: jump_n - 1 for j in range(0, timesteps - jump_len, jump_len)}
    t = timesteps
    ts = []
    while t >= 1:
        t -= 1
        ts.append(t)
        if jumps.get(t, 0) > 0:
            jumps[t] -= 1
            for _ in range(jump_len):
                t += 1
                ts.append(t)
    ts.append(-1)
    t_ops, is_rev = [], []
    for a, b in zip(ts[:-1], ts[1:]):
        if b < a:  # reverse step at level a (always b == a - 1)
            t_ops.append(a)
            is_rev.append(1)
        else:  # forward q-step to level b (always b == a + 1)
            t_ops.append(b)
            is_rev.append(0)
    return np.asarray(t_ops, np.int32), np.asarray(is_rev, np.int32)


@dataclasses.dataclass(frozen=True)
class DiffusionOutput:
    x: torch.Tensor


def _unported(**kw) -> None:
    """Raise for sampler options that later slices of the port bring."""
    given = [k for k, v in kw.items()
             if not (v is None or v is False or (type(v) is float and v == 1.0))]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: not ported yet (ROADMAP queue 11)")


def _draw(noise_fn: Optional[NoiseFn], generator: Optional[torch.Generator],
          i: int, role: str, shape, device) -> torch.Tensor:
    if noise_fn is not None:
        return noise_fn(i, role).to(device=device, dtype=torch.float32)
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Schedule tables plus the reverse processes around a denoiser
    ``model_fn(x, t, cond, y)``."""

    schedule: DiffusionSchedule
    image_size: int
    in_channels: int
    cond_type: Optional[str] = None  # None | "sum" (RePaint) | "concat"
    objective: str = "eps"  # "eps" | "x0" | "v"
    _tables: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @classmethod
    def create(cls, timesteps: int = 1000, image_size: int = 64, in_channels: int = 3,
               cond_type: Optional[str] = None, schedule: str = "cosine_eo",
               objective: str = "eps", zero_terminal_snr: bool = False,
               self_condition: bool = False) -> "GaussianDiffusion":
        assert objective in ("eps", "x0", "v"), objective
        assert not zero_terminal_snr or objective == "v", (
            "zero_terminal_snr requires objective='v' (arXiv:2305.08891 §2.2)")
        _unported(self_condition=self_condition)
        return cls(schedule=make_schedule(timesteps, schedule,
                                          zero_terminal_snr=zero_terminal_snr),
                   image_size=image_size, in_channels=in_channels,
                   cond_type=cond_type, objective=objective)

    @property
    def timesteps(self) -> int:
        return self.schedule.timesteps

    def _table(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(getattr(self.schedule, name),
                                                dtype=torch.float32, device=device)
        return self._tables[key]

    def _bcast(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Per-sample coefficients, broadcast to NHWC."""
        return self._table(name, t.device)[t][:, None, None, None]

    # -- forward process ---------------------------------------------------

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) (reference ``_forward_diffusion``, model.py:94-98)."""
        return (self._bcast("sqrt_alphas_cumprod", t) * x0
                + self._bcast("sqrt_one_minus_alphas_cumprod", t) * noise)

    def _to_eps_x0(self, pred: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor):
        """Model output -> (eps, x0) for the reverse process (float32)."""
        a = self._bcast("sqrt_alphas_cumprod", t)
        s = self._bcast("sqrt_one_minus_alphas_cumprod", t)
        pred, x_t = pred.float(), x_t.float()
        if self.objective == "eps":
            eps = pred
            x0 = (self._bcast("sqrt_recip_alphas_cumprod", t) * x_t
                  - self._bcast("sqrt_recipm1_alphas_cumprod", t) * pred)
        elif self.objective == "x0":
            x0 = pred
            eps = (x_t - a * x0) / torch.clamp(s, min=1e-8)
        else:  # "v": x0 = a*x_t - s*v ; eps = s*x_t + a*v
            x0 = a * x_t - s * pred
            eps = s * x_t + a * pred
        return eps, x0

    # -- reverse process (DDPM) --------------------------------------------

    def _reverse_step(self, model_fn: DenoiseFn, x_t: torch.Tensor, t: torch.Tensor,
                      noise: torch.Tensor, cond, y, clip: bool):
        """One ancestral reverse step. ``clip=False``: posterior mean from the
        predicted noise (reference model.py:101-122); ``clip=True``: clamp
        the predicted x0 to [-1, 1] and use the q-posterior mean
        (model.py:125-150). Returns ``(x_{t-1}, x0_pred)``."""
        pred = model_fn(x_t, t, cond, y).float()
        eps, x0_pred = self._to_eps_x0(pred, x_t, t)
        x_t = x_t.float()
        alpha_t = self._bcast("alphas", t)
        acp_t = self._bcast("alphas_cumprod", t)
        acp_prev = self._bcast("alphas_cumprod_prev", t)
        beta_t = self._bcast("betas", t)
        if clip:
            x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
            mean = (beta_t * torch.sqrt(acp_prev) / (1.0 - acp_t) * x0_pred
                    + (1.0 - acp_prev) * torch.sqrt(alpha_t) / (1.0 - acp_t) * x_t)
        else:
            somacp = self._bcast("sqrt_one_minus_alphas_cumprod", t)
            mean = (1.0 / torch.sqrt(alpha_t)) * (x_t - ((1.0 - alpha_t) / somacp) * eps)
        std = torch.sqrt(beta_t * (1.0 - acp_prev) / (1.0 - acp_t))
        std = torch.where((t > 0)[:, None, None, None], std, torch.zeros_like(std))
        return mean + std * noise.float(), x0_pred

    def ddpm_sample(self, model_fn: DenoiseFn, n_samples: int, *,
                    device, generator: Optional[torch.Generator] = None,
                    cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                    clip: bool = True, dtype: torch.dtype = torch.float32,
                    jump_len: int = 0, jump_n: int = 1,
                    x_T: Optional[torch.Tensor] = None,
                    noise_fn: Optional[NoiseFn] = None,
                    dynamic_threshold=None, guidance_scale: float = 1.0,
                    y_uncond=None, log_every=None, model_state=None) -> DiffusionOutput:
        """Ancestral DDPM sampling (reference ``EODiffusion.sampling``, model.py:47-75).

        RePaint-"sum": when ``cond_type == "sum"``, ``cond`` is (gt | mask);
        before every reverse step the known region is re-noised to level t
        and composited in, with the same noise that drives the step
        (model.py:58-60). ``jump_len``/``jump_n`` add RePaint resampling.
        ``noise_fn(i, "step")`` supplies op ``i``'s noise (default: drawn
        from ``generator``); ``x_T`` the starting noise.
        """
        _unported(dynamic_threshold=dynamic_threshold, guidance_scale=guidance_scale,
                  y_uncond=y_uncond, log_every=log_every, model_state=model_state)
        assert clip or float(self.schedule.alphas[-1]) > 1e-8, (
            "clip=False diverges at a zero-terminal-SNR schedule's last step")
        shape = (n_samples, self.image_size, self.image_size, self.in_channels)
        x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
             else torch.randn(shape, generator=generator, device=device))
        gt = mask = None
        if cond is not None and self.cond_type == "sum":
            c_img = self.in_channels
            gt, mask = cond[..., :c_img].float(), cond[..., c_img:c_img + 1].float()
            cond = None
        if jump_len > 0 and jump_n > 1:
            t_ops, rev_ops = repaint_op_sequence(self.timesteps, jump_len, jump_n)
        else:
            t_ops = np.arange(self.timesteps - 1, -1, -1)
            rev_ops = np.ones_like(t_ops)
        for i, (t_scalar, is_rev) in enumerate(zip(t_ops.tolist(), rev_ops.tolist())):
            noise = _draw(noise_fn, generator, i, "step", shape, device)
            t = torch.full((n_samples,), t_scalar, dtype=torch.long, device=device)
            if is_rev:
                if gt is not None:
                    x = mask * self.q_sample(gt, t, noise) + (1.0 - mask) * x
                x_in = x.to(dtype)
                x, _ = self._reverse_step(lambda *_a: model_fn(x_in, t, cond, y),
                                          x, t, noise, cond, y, clip)
            else:  # RePaint forward op: one q-step up to level t (eq. 9)
                beta_t = self._bcast("betas", t)
                x = torch.sqrt(1.0 - beta_t) * x + torch.sqrt(beta_t) * noise
        return DiffusionOutput(x=x)

    # -- reverse process (DDIM) --------------------------------------------

    def ddim_sample(self, model_fn: DenoiseFn, n_samples: int, *,
                    device, generator: Optional[torch.Generator] = None,
                    num_steps: int = 250, eta: float = 0.0, method: str = "uniform",
                    cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                    x_T: Optional[torch.Tensor] = None, temperature: float = 1.0,
                    clip: bool = False, dtype: torch.dtype = torch.float32,
                    start_index: Optional[int] = None,
                    noise_fn: Optional[NoiseFn] = None,
                    guidance_scale: float = 1.0, uncond=None, y_uncond=None,
                    dynamic_threshold=None, log_every=None, model_state=None,
                    x0_proj=None) -> DiffusionOutput:
        """DDIM sampling (reference ``DDIMSampler``, ddim.py:57-207).

        * eta=0 is the deterministic DDIM ODE (no noise is drawn); eta=1 gives
          ancestral variance on the subsequence (arXiv:2010.02502 eq. 16).
        * ``mask``/``x0``: before each step the known region of x0 is
          re-noised to the current level and composited (ddim.py:145-148).
        * ``clip`` clamps pred_x0 to [-1, 1] and re-derives eps from it.
        * ``start_index``: run only the last ``start_index`` steps.
        * ``noise_fn(i, "mask" | "eta")`` supplies step ``i``'s draws.
        """
        _unported(guidance_scale=guidance_scale, uncond=uncond, y_uncond=y_uncond,
                  dynamic_threshold=dynamic_threshold, log_every=log_every,
                  model_state=model_state, x0_proj=x0_proj)
        dd: DDIMSchedule = make_ddim_schedule(self.schedule, num_steps, eta, method)
        shape = (n_samples, self.image_size, self.image_size, self.in_channels)
        x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
             else torch.randn(shape, generator=generator, device=device))
        alphas_prev = torch.as_tensor(dd.alphas_prev, device=device)
        sigmas = torch.as_tensor(dd.sigmas, device=device)
        start = dd.num_steps if start_index is None else int(start_index)
        assert 1 <= start <= dd.num_steps, (
            f"start_index {start_index} outside the {dd.num_steps}-step subsequence")
        if mask is not None:
            assert x0 is not None, "DDIM inpainting requires x0"
            mask, x0 = mask.float(), x0.float()
        for i, idx in enumerate(range(start - 1, -1, -1)):
            t = torch.full((n_samples,), int(dd.timesteps[idx]), dtype=torch.long,
                           device=device)
            if mask is not None:
                img_orig = self.q_sample(x0, t, _draw(noise_fn, generator, i, "mask",
                                                      shape, device))
                x = img_orig * mask + (1.0 - mask) * x
            raw = model_fn(x.to(dtype), t, cond, y)
            xf = x.float()
            e_t, pred_x0 = self._to_eps_x0(raw, xf, t)
            if clip:
                pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
                a = self._bcast("sqrt_alphas_cumprod", t)
                s = self._bcast("sqrt_one_minus_alphas_cumprod", t)
                e_t = (xf - a * pred_x0) / torch.clamp(s, min=1e-8)
            a_prev, sigma_t = alphas_prev[idx], sigmas[idx]
            dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=0.0)) * e_t
            x = torch.sqrt(a_prev) * pred_x0 + dir_xt
            if eta != 0.0:
                x = x + sigma_t * _draw(noise_fn, generator, i, "eta", shape,
                                        device) * temperature
        return DiffusionOutput(x=x)
