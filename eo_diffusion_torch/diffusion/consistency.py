"""Consistency distillation: 1-4-step sampling from a trained DDPM teacher, in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/consistency.py`` (Song et al.,
arXiv:2303.01469). The student is a consistency function

    f(x_t, t) = c_skip(t) x_t + c_out(t) F(c_in(t) x_t, t)

that jumps from any level of the teacher's chain to the data estimate.
Training holds it to itself along the teacher's probability-flow ODE: for
adjacent grid points t1 < t2, ``d(f_student(x_t2, t2), sg f_target(x_hat_t1,
t1))`` with ``x_hat_t1`` one deterministic DDIM step of the frozen teacher
from the q-sampled ``x_t2`` (or, with no teacher, the same-noise marginal:
consistency training) and the target a slow EMA of the student. Sampling
applies f once from noise, then re-noises and applies f again for each
further step.

The coefficients act on the raw VP ``x_t`` with the ``1 / sqrt(acp)`` rescale
to the VE variable folded in: ``sigma^2 = (1 - acp) / acp``, ``c_skip =
sd^2 / (sigma^2 + sd^2) / sqrt(acp)``, ``c_out = sigma sd / sqrt(sigma^2 +
sd^2)``, ``c_in = 1 / sqrt(1 - acp + acp sd^2)``, float32 from the chain's
table. Random draws come from an explicit ``torch.Generator``; ``idx=`` and
``noise=`` replace the loss's, ``noise_fn(j, "hop")`` the sampler's re-noise
draws, so tests can feed the JAX package's. All tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from eo_diffusion_torch.diffusion.gaussian import (DiffusionOutput, GaussianDiffusion, NoiseFn,
                                                   _draw)

__all__ = ["ConsistencyDistillation"]


@dataclasses.dataclass(frozen=True)
class ConsistencyDistillation:
    """Consistency function and distillation loss over a DDPM teacher chain."""

    diffusion: GaussianDiffusion
    n_points: int = 18  # grid points t_0 = 0 < ... < t_{N-1} = T-1
    sigma_data: float = 0.5
    huber_c: float = 0.0  # 0: squared L2; > 0: pseudo-Huber (improved CT)

    @classmethod
    def create(cls, diffusion: GaussianDiffusion, **kw) -> "ConsistencyDistillation":
        return cls(diffusion=diffusion, **kw)

    # -- grid + coefficients -------------------------------------------------

    def grid(self) -> np.ndarray:
        """The sub-schedule's chain indices ``[n_points]``, uniform over the
        teacher's chain from 0 to T - 1."""
        t = self.diffusion.timesteps
        return np.round(np.linspace(0.0, t - 1, self.n_points)).astype(np.int64)

    def _coeffs(self, t: torch.Tensor):
        """(c_skip, c_out, c_in) ``[N]`` float32 for chain indices t."""
        acp = self.diffusion._table("alphas_cumprod", t.device)[t]
        sd2 = self.sigma_data ** 2
        sig2 = (1.0 - acp) / torch.clamp(acp, min=1e-12)
        den = sig2 + sd2
        c_skip = sd2 / den / torch.sqrt(torch.clamp(acp, min=1e-12))
        c_out = torch.sqrt(sig2 * sd2 / den)
        c_in = torch.rsqrt(1.0 - acp + acp * sd2)
        return c_skip, c_out, c_in

    def f(self, model_fn: Callable, x_t: torch.Tensor, t: torch.Tensor, cond=None,
          y=None) -> torch.Tensor:
        """The consistency function ``f(x_t, t)``, float32: ``model_fn(x, t,
        cond, y)`` sees ``c_in x_t`` in x_t's dtype; ``f(x, 0) ~ x``."""
        c_skip, c_out, c_in = (c[:, None, None, None] for c in self._coeffs(t))
        xf = x_t.float()
        out = model_fn((c_in * xf).to(x_t.dtype), t, cond, y)
        return c_skip * xf + c_out * out.float()

    # -- teacher ODE step ----------------------------------------------------

    def _teacher_ddim_step(self, teacher_fn: Callable, x_t2: torch.Tensor, t2: torch.Tensor,
                           t1: torch.Tensor, cond, y) -> torch.Tensor:
        """One deterministic DDIM step of the teacher t2 -> t1 (eta 0, the
        teacher's objective converted)."""
        d = self.diffusion
        raw = teacher_fn(x_t2, t2, cond, y)
        eps, x0_pred = d._to_eps_x0(raw, x_t2.float(), t2)
        acp1 = d._table("alphas_cumprod", t1.device)[t1][:, None, None, None]
        return torch.sqrt(acp1) * x0_pred + torch.sqrt(1.0 - acp1) * eps

    # -- training ------------------------------------------------------------

    def distill_loss(self, student_fn: Callable, target_fn: Callable,
                     teacher_fn: Optional[Callable], x0: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None, cond=None, y=None,
                     idx: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The self-consistency loss of one batch (Song et al. Algorithm 2;
        JAX ``distill_loss``): the student carries the gradient, the target
        and the teacher run without one. ``teacher_fn=None`` is consistency
        training (Algorithm 3): the target's input is ``q_sample(x0, t1,
        eps)`` with the same eps. ``idx`` ``[N]`` (grid positions in [0,
        n_points - 1)) and ``noise`` replace the draws, made in that order."""
        n, device = x0.shape[0], x0.device
        if idx is None:
            idx = torch.randint(0, self.n_points - 1, (n,), generator=generator, device=device)
        g = torch.as_tensor(self.grid(), device=device)
        idx = idx.to(device=device, dtype=torch.long)
        t1, t2 = g[idx], g[idx + 1]
        eps = (noise.to(device=device, dtype=torch.float32) if noise is not None
               else torch.randn(x0.shape, generator=generator, device=device))
        x0f = x0.float()
        x_t2 = self.diffusion.q_sample(x0f, t2, eps)
        with torch.no_grad():
            if teacher_fn is None:
                x_t1_hat = self.diffusion.q_sample(x0f, t1, eps)
            else:
                x_t1_hat = self._teacher_ddim_step(teacher_fn, x_t2, t2, t1, cond, y)
            f1 = self.f(target_fn, x_t1_hat, t1, cond, y)
        f2 = self.f(student_fn, x_t2, t2, cond, y)
        err = (f2 - f1) ** 2
        if self.huber_c > 0.0:  # pseudo-Huber (arXiv:2310.14189 eq. 9)
            per = torch.sqrt(err.sum(dim=(1, 2, 3)) + self.huber_c ** 2) - self.huber_c
            return per.mean()
        return err.mean()

    @staticmethod
    @torch.no_grad()
    def update_target(target_params: Iterable[torch.Tensor],
                      student_params: Iterable[torch.Tensor], decay: float = 0.95) -> None:
        """The slow-EMA target, in place: ``theta^- <- decay theta^- + (1 -
        decay) theta``."""
        target, student = list(target_params), list(student_params)
        torch._foreach_mul_(target, decay)
        torch._foreach_add_(target, student, alpha=1.0 - decay)

    # -- sampling ------------------------------------------------------------

    def sample(self, student_fn: Callable, n_samples: int, *, device,
               generator: Optional[torch.Generator] = None, steps: int = 1, cond=None,
               y=None, x_T: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
               noise_fn: Optional[NoiseFn] = None) -> DiffusionOutput:
        """Algorithm 1: f from pure noise at the last grid level, then
        ``steps - 1`` hops, each a re-noise ``q_sample(x, t_j, eps_j)`` at
        descending grid levels (``noise_fn(j, "hop")`` supplies eps_j) and f
        again (JAX ``ConsistencyDistillation.sample``)."""
        d = self.diffusion
        shape = (n_samples, d.image_size, d.image_size, d.in_channels)
        g = self.grid()
        x_T = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
               else torch.randn(shape, generator=generator, device=device))
        full = lambda tj: torch.full((n_samples,), int(tj), dtype=torch.long, device=device)
        x = self.f(student_fn, x_T.to(dtype), full(g[-1]), cond, y)
        if steps > 1:
            hop_idx = np.linspace(self.n_points - 1, 0, steps + 1)[1:-1].round().astype(int)
            for j, tj in enumerate(g[hop_idx]):
                eps = _draw(noise_fn, generator, j, "hop", shape, device)
                x_tj = d.q_sample(x, full(tj), eps)
                x = self.f(student_fn, x_tj.to(dtype), full(tj), cond, y)
        return DiffusionOutput(x=x)
