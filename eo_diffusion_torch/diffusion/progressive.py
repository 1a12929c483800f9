"""Progressive distillation (Salimans & Ho 2022, arXiv:2202.00512), in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/progressive.py``. A student
learns to match two deterministic DDIM steps of its teacher in one; once it
has, it becomes the teacher and the grid halves again, so a few rounds turn
a 1000-step DDPM into a 2-4-step sampler. As in the JAX package:

* students are v-parameterized (the paper's section 4): the student's raw
  output is read as v whatever the teacher's objective;
* the loss regresses one student step onto the teacher's two-step endpoint
  in endpoint space: with ``a = sqrt(acp)``, ``s = sqrt(1 - acp)`` and
  ``ratio = s_lo / s_hi``, an eta-0 DDIM step is ``x_lo(x0) = (a_lo - ratio
  a_hi) x0 + ratio x_hi``, and ``loss = ||x_lo(x0_student) -
  x_lo_teacher||^2``;
* the teacher's steps clamp pred_x0 to [-1, 1] and re-derive eps ("clip
  denoised"), and so does :func:`pd_sample` by default.

Grids are host numpy arrays. Random draws come from an explicit
``torch.Generator``; ``k=`` and ``noise=`` replace the loss's, so tests can
feed the JAX package's. All tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from eo_diffusion_torch.diffusion.gaussian import DiffusionOutput, GaussianDiffusion

__all__ = ["ProgressiveDistillation", "pd_sample"]


def _grid(timesteps: int, n_points: int) -> np.ndarray:
    """Ascending integer grid 0..T-1 with ``n_points`` entries."""
    g = np.round(np.linspace(0.0, timesteps - 1, n_points)).astype(np.int64)
    assert (np.diff(g) > 0).all(), (
        f"{n_points}-point grid over T={timesteps} collides; use fewer steps or more timesteps")
    return g


@dataclasses.dataclass(frozen=True)
class ProgressiveDistillation:
    """One halving round: the teacher on 2N steps, the student on N.

    ``teacher_process`` reads the teacher's raw output (round 1: the trained
    preset's process; later rounds the previous v student);
    ``student_process`` is the same schedule with the student's objective
    ("v" by default); ``n_student`` the student's DDIM steps this round."""

    teacher_process: GaussianDiffusion
    student_process: GaussianDiffusion
    n_student: int

    @classmethod
    def create(cls, diffusion: GaussianDiffusion, n_student: int,
               student_objective: str = "v",
               teacher_objective: Optional[str] = None) -> "ProgressiveDistillation":
        assert n_student >= 1
        _grid(diffusion.timesteps, 2 * n_student + 1)  # validates
        teacher = (diffusion if teacher_objective is None
                   else dataclasses.replace(diffusion, objective=teacher_objective))
        student = dataclasses.replace(diffusion, objective=student_objective)
        return cls(teacher_process=teacher, student_process=student, n_student=n_student)

    def grid(self) -> np.ndarray:
        """2N + 1 ascending chain indices; the student steps on the even ones."""
        return _grid(self.teacher_process.timesteps, 2 * self.n_student + 1)

    def _a_s(self, t: torch.Tensor):
        acp = self.teacher_process._table("alphas_cumprod", t.device)[t][:, None, None, None]
        return torch.sqrt(acp), torch.sqrt(1.0 - acp)

    def _ddim_step(self, fn: Callable, x_t: torch.Tensor, t_from: torch.Tensor,
                   t_to: torch.Tensor, cond, y) -> torch.Tensor:
        """One deterministic teacher DDIM step t_from -> t_to (eta 0, the
        objective converted, pred_x0 clamped and eps re-derived)."""
        xf = x_t.float()
        raw = fn(x_t, t_from, cond, y)
        eps, x0 = self.teacher_process._to_eps_x0(raw, xf, t_from)
        x0 = torch.clamp(x0, -1.0, 1.0)
        a_from, s_from = self._a_s(t_from)
        eps = (xf - a_from * x0) / torch.clamp(s_from, min=1e-8)
        a_to, s_to = self._a_s(t_to)
        return a_to * x0 + s_to * eps

    def distill_loss(self, student_fn: Callable, teacher_fn: Callable, x0: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None, cond=None, y=None,
                     k: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The two-steps-into-one regression of one batch (paper Algorithm 2;
        JAX ``distill_loss``): two teacher steps without a gradient, one
        student call with it. ``k`` ``[N]`` (student steps in [0,
        n_student)) and ``noise`` replace the draws, made in that order."""
        n, device = x0.shape[0], x0.device
        if k is None:
            k = torch.randint(0, self.n_student, (n,), generator=generator, device=device)
        g = torch.as_tensor(self.grid(), device=device)
        k = k.to(device=device, dtype=torch.long)
        t_lo, t_mid, t_hi = g[2 * k], g[2 * k + 1], g[2 * k + 2]
        eps = (noise.to(device=device, dtype=torch.float32) if noise is not None
               else torch.randn(x0.shape, generator=generator, device=device))
        x_hi = self.teacher_process.q_sample(x0.float(), t_hi, eps)
        with torch.no_grad():
            x_mid = self._ddim_step(teacher_fn, x_hi, t_hi, t_mid, cond, y)
            x_lo_t = self._ddim_step(teacher_fn, x_mid, t_mid, t_lo, cond, y)
        a_hi, s_hi = self._a_s(t_hi)
        a_lo, s_lo = self._a_s(t_lo)
        ratio = s_lo / torch.clamp(s_hi, min=1e-8)
        raw = student_fn(x_hi, t_hi, cond, y)
        _, x0_s = self.student_process._to_eps_x0(raw, x_hi, t_hi)
        x_lo_s = (a_lo - ratio * a_hi) * x0_s + ratio * x_hi
        return ((x_lo_s - x_lo_t) ** 2).mean()

    def sample(self, model_fn: Callable, n_samples: int, **kw) -> DiffusionOutput:
        """Sample the student on this round's grid (:func:`pd_sample` with the
        student's objective)."""
        return pd_sample(self.student_process, model_fn, n_samples, steps=self.n_student, **kw)


def pd_sample(diffusion: GaussianDiffusion, model_fn: Callable, n_samples: int, *, device,
              generator: Optional[torch.Generator] = None, steps: int = 4, cond=None, y=None,
              x_T: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
              model_state=None, clip: bool = True) -> DiffusionOutput:
    """Deterministic DDIM on the progressive-distillation grid (``steps + 1``
    points of ``linspace(0, T - 1)``; JAX ``pd_sample``).
    ``diffusion.objective`` must be the checkpoint's head: "v" for students
    of ``cli.distill --method progressive``. ``clip`` clamps pred_x0 each
    hop and re-derives eps. ``model_state``: a stateful denoiser ``fn(x, t,
    cond, y, state, i) -> (out, state)``."""
    g = _grid(diffusion.timesteps, steps + 1)
    shape = (n_samples, diffusion.image_size, diffusion.image_size, diffusion.in_channels)
    x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
         else torch.randn(shape, generator=generator, device=device))
    acp = diffusion._table("alphas_cumprod", device)
    state = model_state
    for i in range(steps):
        t_hi, t_lo = int(g[steps - i]), int(g[steps - i - 1])
        t = torch.full((n_samples,), t_hi, dtype=torch.long, device=device)
        if state is None:
            raw = model_fn(x.to(dtype), t, cond, y)
        else:
            raw, state = model_fn(x.to(dtype), t, cond, y, state, i)
        eps, x0 = diffusion._to_eps_x0(raw, x, t)
        if clip:
            x0 = torch.clamp(x0, -1.0, 1.0)
            eps = (x - torch.sqrt(acp[t_hi]) * x0) / torch.clamp(torch.sqrt(1.0 - acp[t_hi]),
                                                                 min=1e-8)
        x = torch.sqrt(acp[t_lo]) * x0 + torch.sqrt(1.0 - acp[t_lo]) * eps
    return DiffusionOutput(x=x)
