"""Brownian-bridge diffusion (BBDM) for paired image-to-image translation, in
PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/bridge.py`` (Li et al., "BBDM:
Image-to-Image Translation with Brownian Bridge Diffusion Models", CVPR
2023, arXiv:2205.07680). The process pins both ends: with source image y
(the cloudy view) and target x0 (the clear view)

    x_t = (1 - m_t) x0 + m_t y + sqrt(delta_t) eps
    m_t = t / (T - 1),    delta_t = 2 s (m_t - m_t^2)

so x_{T-1} = y exactly and sampling starts at the source. The network
regresses ``m_t (y - x0) + sqrt(delta_t) eps`` (BBDM eq. 9), so the data
prediction is ``x0_hat = x_t - pred``. The reverse step is the exact
Gaussian bridge posterior q(x_s | x_t, x0_hat, y) for any s < t, in the
Kalman form of :meth:`BrownianBridge.posterior_step`, which serves the
strided sampler and ``tiled.tiled_bridge_sample`` alike.

The strided grid's time indices are host integers and its ``m`` / ``delta``
tables float32, computed from them as the JAX package computes them
(:meth:`BrownianBridge.strided_grid`); the posterior's scalars stay float32
on the host. x is carried in float32 and only the model input is cast to
``dtype``. The posterior noise comes from an explicit ``torch.Generator``,
or ``noise_fn(i, "eta")``; at ``eta == 0`` nothing is drawn. ``log_every=k``
keeps the x after every k-th step. All tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from eo_diffusion_torch.diffusion.gaussian import (DenoiseFn, DiffusionOutput, NoiseFn, _draw,
                                                   log_frames, stack_frames)

__all__ = ["BrownianBridge"]


@dataclasses.dataclass(frozen=True)
class BrownianBridge:
    """Discrete Brownian-bridge process between paired images.

    ``cond`` below is the source image y, and it is required: it is the far
    endpoint of the bridge. With ``cond_type="concat"`` (the presets') the
    source is also channel-concatenated into the denoiser; ``cond_type=None``
    is the paper's pure form, where y enters through the bridge only.
    """

    image_size: int
    in_channels: int
    timesteps: int = 1000
    max_var: float = 1.0  # s in delta_t = 2 s (m_t - m_t^2)
    cond_type: Optional[str] = "concat"

    @classmethod
    def create(cls, image_size: int = 64, in_channels: int = 3, timesteps: int = 1000,
               cond_type: Optional[str] = "concat", **kw) -> "BrownianBridge":
        assert cond_type in (None, "concat"), (
            f"BrownianBridge supports cond_type None|'concat', got {cond_type!r} (sum/RePaint "
            f"is a masking protocol; the bridge is already image-conditional through its "
            f"endpoint)")
        return cls(image_size=image_size, in_channels=in_channels, timesteps=timesteps,
                   cond_type=cond_type, **kw)

    # -- schedule -------------------------------------------------------------

    def _m(self, t: torch.Tensor) -> torch.Tensor:
        return t.float() / float(self.timesteps - 1)

    def _delta(self, m):
        return 2.0 * self.max_var * (m - m * m)

    def marginal(self, x0: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                 eps: torch.Tensor) -> torch.Tensor:
        """``x_t = (1 - m_t) x0 + m_t y + sqrt(delta_t) eps`` (BBDM eq. 4-5)."""
        m = self._m(t)[:, None, None, None]
        return (1.0 - m) * x0 + m * y + torch.sqrt(self._delta(m)) * eps

    # -- training -------------------------------------------------------------

    def training_tuple(self, x0: torch.Tensor, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       cond: Optional[torch.Tensor] = None,
                       t: Optional[torch.Tensor] = None):
        """One training instance ``(x_t, t, target)``: x_t in x0's dtype, the
        integer steps t ~ U{1, T-1} (t 0 is the identity instance) and the
        target ``m_t (y - x0) + sqrt(delta_t) eps`` in float32. ``cond`` is
        the endpoint y and is required; t is drawn before eps, and ``t`` and
        ``noise`` replace the draws."""
        assert cond is not None, "BrownianBridge training requires the source image (cond)"
        n = x0.shape[0]
        if t is None:
            t = torch.randint(1, self.timesteps, (n,), generator=generator, device=x0.device)
        t = t.to(device=x0.device, dtype=torch.long)
        eps = (noise.to(device=x0.device, dtype=torch.float32) if noise is not None
               else torch.randn(x0.shape, generator=generator, device=x0.device))
        x0f, yf = x0.float(), cond.float()
        m = self._m(t)[:, None, None, None]
        sd = torch.sqrt(self._delta(m))
        x_t = (1.0 - m) * x0f + m * yf + sd * eps
        target = m * (yf - x0f) + sd * eps
        return x_t.to(x0.dtype), t, target

    def train_loss(self, model_fn: DenoiseFn, x0: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The BBDM residual MSE in float32 (JAX ``BrownianBridge.train_loss``,
        ``diffusion/bridge.py:125-135``). ``cond`` (the source image) shapes
        the bridge and, with ``cond_type="concat"``, conditions the model."""
        x_t, t, target = self.training_tuple(x0, generator, noise, cond, t)
        pred = model_fn(x_t, t, cond if self.cond_type == "concat" else None, y)
        return ((pred.float() - target) ** 2).mean()

    # -- sampling -------------------------------------------------------------

    def strided_grid(self, num_steps: int):
        """``(num_steps, t_seq, m_seq, d_seq)`` of an S-step strided chain
        (JAX ``strided_grid``): ``num_steps`` clamped to T-1, which must
        replace the caller's; the time indices ``round(linspace(T-1, 0,
        S+1))`` as int32, then ``m = t / (T-1)`` and ``delta`` in float32
        from those integers (numpy arrays on the host)."""
        T = self.timesteps
        assert num_steps >= 1, num_steps
        num_steps = min(num_steps, T - 1)
        t_seq = np.linspace(T - 1, 0, num_steps + 1).round().astype(np.int32)
        assert len(np.unique(t_seq)) == len(t_seq), "strided grid collapsed; lower num_steps"
        m_seq = t_seq.astype(np.float32) / np.float32(T - 1)
        d_seq = np.float32(2.0 * self.max_var) * (m_seq - m_seq * m_seq)
        return num_steps, t_seq, m_seq, d_seq

    @staticmethod
    def posterior_step(x: torch.Tensor, x0_hat: torch.Tensor, yf: torch.Tensor,
                       m_t, m_s, d_t, d_s):
        """One strided bridge posterior update in the Kalman form: ``(mean,
        var)`` of x_s | x_t, x0_hat, y, the mean a tensor and the variance a
        float32 scalar. The scalars are computed in float32 on the host; the
        ``d_t == 0`` branch covers the endpoints where the bridge variance
        vanishes (at t = T-1 the prior N(mu_s, d_s), at s = 0 N(x0_hat, 0))."""
        m_t, m_s, d_t, d_s = (np.float32(v) for v in (m_t, m_s, d_t, d_s))
        one, zero = np.float32(1.0), np.float32(0.0)
        a = (one - m_t) / (one - m_s)  # m_s < 1 for every s < t <= T-1
        if d_t > zero:
            gain = a * d_s / d_t
            var = d_s * max(d_t - a * a * d_s, zero) / d_t
        else:
            gain, var = zero, d_s
        mu_t = float(one - m_t) * x0_hat + float(m_t) * yf
        mu_s = float(one - m_s) * x0_hat + float(m_s) * yf
        return mu_s + float(gain) * (x - mu_t), var

    def sample(self, model_fn: DenoiseFn, n_samples: int, *, device,
               generator: Optional[torch.Generator] = None, num_steps: int = 50,
               cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
               clip: bool = True, log_every=None, dtype: torch.dtype = torch.float32,
               model_state=None, eta: float = 1.0,
               noise_fn: Optional[NoiseFn] = None) -> DiffusionOutput:
        """Translate ``cond`` (the source) to the target domain in
        ``num_steps`` strided posterior steps (JAX ``BrownianBridge.sample``,
        ``diffusion/bridge.py:171-235``). x starts at the source, where the
        marginal is exactly y; the model sees the integer step. ``clip``
        clamps x0_hat to [-1, 1]; ``eta`` scales the posterior noise (1 the
        ancestral bridge, 0 the deterministic mean path, which draws
        nothing). ``model_state``: a stateful denoiser ``fn(x, t, cond, y,
        state, i) -> (out, state)``."""
        assert cond is not None, "BrownianBridge sampling requires the source image (cond)"
        shape = (n_samples, self.image_size, self.image_size, self.in_channels)
        num_steps, t_seq, m_seq, d_seq = self.strided_grid(num_steps)
        yf = cond.to(device=device, dtype=torch.float32)
        c_model = yf.to(dtype) if self.cond_type == "concat" else None
        x = yf.expand(shape).clone()  # x_{T-1} = y exactly; a copy, never a view of cond
        state = model_state
        frames = []
        for i in range(num_steps):
            t_i = torch.full((n_samples,), int(t_seq[i]), dtype=torch.long, device=device)
            if state is None:
                pred = model_fn(x.to(dtype), t_i, c_model, y)
            else:
                pred, state = model_fn(x.to(dtype), t_i, c_model, y, state, i)
            x0_hat = x - pred.float()
            if clip:
                x0_hat = torch.clamp(x0_hat, -1.0, 1.0)
            mean, var = self.posterior_step(x, x0_hat, yf, m_seq[i], m_seq[i + 1],
                                            d_seq[i], d_seq[i + 1])
            if eta != 0.0:
                noise = _draw(noise_fn, generator, i, "eta", shape, device)
                mean = mean + float(np.float32(eta) * np.sqrt(var)) * noise
            x = mean
            log_frames(frames, x, i, log_every, dtype)
        return DiffusionOutput(x=x, intermediates=stack_frames(frames))
