"""SDEdit: editing by partial noising (Meng et al., arXiv:2108.01073), in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/edit.py``. The source image is
noised part of the way up the forward process and only the tail of the
reverse chain runs: a low ``strength`` keeps the source's structure, 1.0 is
ordinary sampling. On a DDPM chain the tail is DDIM's (``start_index``), on
rectified flow the Euler/Heun integrator's; through
:class:`~eo_diffusion_torch.diffusion.latent.LatentDiffusion` the source
rides the first stage's encoder and the tail runs on the latent grid.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from eo_diffusion_torch.core.schedules import make_ddim_schedule
from eo_diffusion_torch.diffusion.gaussian import DiffusionOutput, GaussianDiffusion

__all__ = ["sdedit_plan", "sdedit_sample"]


def sdedit_plan(num_steps: int, strength: float) -> int:
    """The number of steps of the truncated chain: ``round(strength *
    num_steps)`` in [1, num_steps], strength in (0, 1]."""
    assert 0.0 < strength <= 1.0, f"strength {strength} outside (0, 1]"
    return int(np.clip(round(strength * num_steps), 1, num_steps))


def sdedit_sample(diffusion: Any, model_fn: Callable, source: torch.Tensor, strength: float,
                  *, device, generator: Optional[torch.Generator] = None,
                  num_steps: int = 50, eta: float = 0.0, method: str = "uniform",
                  noise: Optional[torch.Tensor] = None, **kw) -> DiffusionOutput:
    """Edit ``source`` ``[N, H, W, C]`` by noising it to ``strength`` and
    denoising back (JAX ``sdedit_sample``).

    ``diffusion`` is a :class:`GaussianDiffusion` (the DDIM tail, from
    ``q_sample`` at ``dd.timesteps[k - 1]``), a ``FlowMatching`` (the
    straight-line point ``(1 - t) x + t eps`` at ``t = k / num_steps``, then
    its integrator) or a ``LatentDiffusion`` around either. ``method`` is the
    DDIM spacing on DDPM chains and the integrator ("euler" / "heun") on
    flow; the DDIM default "uniform" means Euler there. ``noise`` replaces
    the draw of eps from ``generator`` (a test feeds another framework's);
    the other ``kw`` (cond, y, guidance, model_state, dtype, ...) go to the
    sampler.
    """
    is_latent = hasattr(diffusion, "encode")
    inner = diffusion.diffusion if is_latent else diffusion
    source = source.to(device)
    src = (diffusion.encode(source) if is_latent else source).float()
    n = src.shape[0]
    eps = (noise.to(device=device, dtype=torch.float32) if noise is not None
           else torch.randn(src.shape, generator=generator, device=device))
    if isinstance(inner, GaussianDiffusion):
        dd = make_ddim_schedule(inner.schedule, num_steps, eta, method)
        k = sdedit_plan(dd.num_steps, strength)
        t_enc = torch.full((n,), int(dd.timesteps[k - 1]), dtype=torch.long, device=device)
        x_T = inner.q_sample(src, t_enc, eps)
        return diffusion.ddim_sample(model_fn, n, device=device, generator=generator,
                                     num_steps=num_steps, eta=eta, method=method, x_T=x_T,
                                     start_index=k, **kw)
    if method == "uniform":
        method = "euler"
    k = sdedit_plan(num_steps, strength)
    t_enc = k / num_steps
    x_T = (1.0 - t_enc) * src + t_enc * eps
    return diffusion.sample(model_fn, n, device=device, generator=generator,
                            num_steps=num_steps, method=method, x_T=x_T, start_index=k, **kw)
