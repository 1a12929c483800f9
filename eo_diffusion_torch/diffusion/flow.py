"""Flow matching / rectified flow: the training loss and the sampler, in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/flow.py`` (Lipman et al.,
arXiv:2210.02747; Liu et al., arXiv:2209.03003): the straight path ``x_t =
(1 - t) * x0 + t * eps`` over t in [0, 1], and a network that regresses the
velocity ``eps - x0``. Sampling integrates ``dx/dt = v(x, t)`` from t = 1
(noise) to t = 0 (data) with Euler or Heun steps on a uniform grid. The model
sees ``t * time_scale``, so the sinusoidal timestep embedding works in the
range the backbones were built for.

Training draws t (uniform, or SD3's logit-normal) and eps and regresses
``eps - x0`` at ``x_t`` with an f32 MSE (:meth:`FlowMatching.train_loss`);
``noise=`` pins the endpoint pairing (ReFlow couplings) and ``t=`` the draw
of t, so tests can feed the JAX package's draws.

x is carried in float32 and only the model input is cast to ``dtype``. Random
draws come from an explicit ``torch.Generator``; ``noise_fn(i, "mask")``
replaces the inpainting draw of step ``i``, so tests can feed the JAX
package's draws. All tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from eo_diffusion_torch.diffusion.gaussian import (DenoiseFn, DiffusionOutput, NoiseFn, _draw,
                                                   _unported)

__all__ = ["FlowMatching"]


@dataclasses.dataclass(frozen=True)
class FlowMatching:
    """Rectified-flow process over [0, 1] with straight-line paths."""

    image_size: int
    in_channels: int
    cond_type: Optional[str] = None  # None | "concat" (cond passed to the model) | "sum"
    time_scale: float = 1000.0  # the model sees t * time_scale
    # SD3-style logit-normal time sampling concentrates training mid-path;
    # "uniform" is the plain flow-matching objective
    time_sampling: str = "uniform"  # "uniform" | "logit_normal"
    logit_norm_scale: float = 1.0

    @classmethod
    def create(cls, image_size: int = 64, in_channels: int = 3,
               cond_type: Optional[str] = None, **kw) -> "FlowMatching":
        return cls(image_size=image_size, in_channels=in_channels, cond_type=cond_type, **kw)

    # -- training ------------------------------------------------------------

    def _sample_t(self, n: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
        """``n`` times in [0, 1] (float32): uniform, or the sigmoid of a
        normal draw scaled by ``logit_norm_scale``."""
        if self.time_sampling == "logit_normal":
            z = torch.randn(n, generator=generator, device=device) * self.logit_norm_scale
            return torch.sigmoid(z)
        assert self.time_sampling == "uniform", self.time_sampling
        return torch.rand(n, generator=generator, device=device)

    def training_tuple(self, x0: torch.Tensor, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       t: Optional[torch.Tensor] = None):
        """One training instance ``(x_t, t_model, target)`` with ``loss =
        mean((model(x_t, t_model) - target)^2)``: x_t in x0's dtype,
        ``t_model = t * time_scale`` and the target ``eps - x0`` in float32.
        t is drawn before eps; ``t`` (in [0, 1]) and ``noise`` replace the
        draws."""
        n = x0.shape[0]
        if t is None:
            t = self._sample_t(n, generator, x0.device)
        t = t.to(device=x0.device, dtype=torch.float32)
        eps = (noise.to(device=x0.device, dtype=torch.float32) if noise is not None
               else torch.randn(x0.shape, generator=generator, device=x0.device))
        x0f = x0.float()
        tb = t[:, None, None, None]
        x_t = (1.0 - tb) * x0f + tb * eps
        return x_t.to(x0.dtype), t * self.time_scale, eps - x0f

    def train_loss(self, model_fn: DenoiseFn, x0: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Conditional flow-matching MSE ``||model(x_t, t) - (eps - x0)||^2``
        in float32 (JAX ``FlowMatching.train_loss``, ``diffusion/flow.py:93``)."""
        x_t, t_model, target = self.training_tuple(x0, generator, noise, t)
        pred = model_fn(x_t, t_model, cond, y)
        return ((pred.float() - target) ** 2).mean()

    def sample(self, model_fn: DenoiseFn, n_samples: int, *, device,
               generator: Optional[torch.Generator] = None, num_steps: int = 32,
               method: str = "euler", cond: Optional[torch.Tensor] = None,
               y: Optional[torch.Tensor] = None, x_T: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.float32, start_index: Optional[int] = None,
               noise_fn: Optional[NoiseFn] = None, guidance_scale: float = 1.0,
               guidance_rescale: float = 0.0, guidance_interval=None, uncond=None,
               y_uncond=None, log_every=None, model_state=None) -> DiffusionOutput:
        """Integrate the velocity ODE from t = 1 to t = 0 (JAX
        ``FlowMatching.sample``, ``diffusion/flow.py:116-231``).

        * The grid is ``linspace(start / num_steps, 0, start + 1)``;
          ``start_index=k`` runs only its last k intervals (start = k).
        * ``method="heun"``: the second-order step, two model calls an
          interval, except the last interval (t_next = 0), which is an Euler
          step with one call.
        * ``mask``/``x0``: before each step the known region (mask 1) is put
          back on the straight path at the current time, ``(1 - t) * x0 + t *
          eps`` with a fresh eps (``noise_fn(i, "mask")``), and after the
          last step x0 is pasted in.
        """
        _unported(guidance_scale=guidance_scale, guidance_rescale=guidance_rescale or None,
                  guidance_interval=guidance_interval, uncond=uncond, y_uncond=y_uncond,
                  log_every=log_every or None, model_state=model_state)
        if method not in ("euler", "heun"):
            raise ValueError(f"method must be 'euler' or 'heun', got {method!r}")
        if mask is not None:
            assert x0 is not None, "flow inpainting requires x0 (known image)"
            mask, x0 = mask.float(), x0.float()
        shape = (n_samples, self.image_size, self.image_size, self.in_channels)
        x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
             else torch.randn(shape, generator=generator, device=device))
        start = num_steps if start_index is None else int(start_index)
        assert 1 <= start <= num_steps, (
            f"start_index {start_index} outside the {num_steps}-interval grid")
        ts = torch.as_tensor(np.linspace(start / num_steps, 0.0, start + 1), dtype=torch.float32,
                             device=device)

        def call(xx, t):
            tt = (t * self.time_scale).expand(n_samples)
            return model_fn(xx.to(dtype), tt, cond, y).float()

        for i in range(start):
            t_i, t_next = ts[i], ts[i + 1]
            dt = t_next - t_i  # negative: toward the data
            if mask is not None:
                eps = _draw(noise_fn, generator, i, "mask", shape, device)
                x = mask * ((1.0 - t_i) * x0 + t_i * eps) + (1.0 - mask) * x
            v = call(x, t_i)
            if method == "heun" and i < start - 1:
                v = 0.5 * (v + call(x + dt * v, t_next))
            x = x + dt * v
        if mask is not None:
            x = mask * x0 + (1.0 - mask) * x
        return DiffusionOutput(x=x)
