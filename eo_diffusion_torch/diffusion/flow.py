"""Flow matching / rectified flow: the sampler, in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/flow.py`` (Lipman et al.,
arXiv:2210.02747; Liu et al., arXiv:2209.03003): the straight path ``x_t =
(1 - t) * x0 + t * eps`` over t in [0, 1], and a network that regresses the
velocity ``eps - x0``. Sampling integrates ``dx/dt = v(x, t)`` from t = 1
(noise) to t = 0 (data) with Euler or Heun steps on a uniform grid. The model
sees ``t * time_scale``, so the sinusoidal timestep embedding works in the
range the backbones were built for.

x is carried in float32 and only the model input is cast to ``dtype``. Random
draws come from an explicit ``torch.Generator``; ``noise_fn(i, "mask")``
replaces the inpainting draw of step ``i``, so tests can feed the JAX
package's draws. All tensors are NHWC. The training loss comes with the
training slice of this family (ROADMAP queue 10).
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

    @classmethod
    def create(cls, image_size: int = 64, in_channels: int = 3,
               cond_type: Optional[str] = None, **kw) -> "FlowMatching":
        return cls(image_size=image_size, in_channels=in_channels, cond_type=cond_type, **kw)

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
