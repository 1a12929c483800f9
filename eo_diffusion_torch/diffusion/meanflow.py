"""MeanFlow: one-step generation through average velocity fields, in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/meanflow.py`` (Geng et al.,
arXiv:2505.13447). The model learns the *average* velocity over an interval,
``u(z_t, r, t) = 1 / (t - r) * integral_r^t v(z_tau, tau) dtau``, on the
straight path ``z_t = (1 - t) x0 + t eps`` of rectified flow. The MeanFlow
identity ``u = v - (t - r) du/dt`` gives the training target, with the
total derivative ``du/dt = v . grad_z u + partial_t u`` taken as one
``torch.func.jvp`` through the network with tangents ``(v, 1, 0)`` on ``(z,
t, r)``; gradients flow through the primal ``u`` only.

On the card the network's GroupNorms and routed 3x3 convs run their kernels
inside that JVP: :class:`~eo_diffusion_torch.ops.group_norm.GroupNormFn` and
:class:`~eo_diffusion_torch.ops.conv_wgrad.Conv3x3Fn` carry forward-mode
rules. Attention has none, as in the JAX package, so a MeanFlow backbone
pins ``attn_impl="plain"`` (``cli.presets``).

Sampling needs no solver: ``z_r = z_t - (t - r) u(z_t, r, t)`` holds exactly
under the learned field, so one model call maps noise to data and an n-step
sampler splits [0, 1] into n segments. A dual-time backbone
(``UNetConfig.dual_time`` / ``DiTConfig.dual_time``) takes the two times
packed as ``t = stack([t, r], -1) * time_scale``.

Random draws come from an explicit ``torch.Generator``; ``t=`` (the (t, r)
pair), ``noise=`` and ``dropped=`` replace the training draws and
``noise_fn(i, "mask")`` the sampler's inpainting draws, so tests can feed
the JAX package's. All tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from eo_diffusion_torch.diffusion.flow import time_grid
from eo_diffusion_torch.diffusion.gaussian import (DenoiseFn, DiffusionOutput, NoiseFn, _draw,
                                                   call_guided, log_frames, stack_frames)

__all__ = ["MeanFlow"]


@dataclasses.dataclass(frozen=True)
class MeanFlow:
    """Average-velocity process over [0, 1] with straight-line paths (the
    marginals of :class:`~eo_diffusion_torch.diffusion.flow.FlowMatching`,
    so the mask composite and SDEdit's tail carry over)."""

    image_size: int
    in_channels: int
    cond_type: Optional[str] = None  # None | "concat" | "sum" (sampling-time inpainting)
    time_scale: float = 1000.0  # the model sees t * time_scale
    # the share of training samples with r != t (the rest see r == t, where
    # the identity is plain flow matching)
    ratio_rt: float = 0.5
    # (t, r) drawn logit-normal (mu, sigma), or "uniform"
    time_sampling: str = "logit_normal"
    logit_mean: float = -0.4
    logit_std: float = 1.0
    # adaptive weighting w = 1 / (||delta||^2 + c)^p, the weight stop-graded;
    # p = 0 is plain MSE
    adaptive_p: float = 1.0
    adaptive_c: float = 1e-3
    # CFG-integrated training (paper section 4): omega > 1 trains the
    # omega-guided average velocity, with the loss's own label dropout to the
    # null row cfg_null_index
    cfg_omega: float = 1.0
    cfg_dropout: float = 0.1
    cfg_null_index: Optional[int] = None

    @classmethod
    def create(cls, image_size: int = 64, in_channels: int = 3,
               cond_type: Optional[str] = None, **kw) -> "MeanFlow":
        return cls(image_size=image_size, in_channels=in_channels, cond_type=cond_type, **kw)

    # -- time plumbing -------------------------------------------------------

    def pack_time(self, t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """(t, r) in [0, 1] -> the dual-time model input ``[N, 2]``."""
        return torch.stack([t, r], dim=-1) * self.time_scale

    def _sample_tr(self, n: int, generator: Optional[torch.Generator],
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t, r) with r <= t, and r == t for a (1 - ratio_rt) share."""
        if self.time_sampling == "logit_normal":
            z = (torch.randn(n, 2, generator=generator, device=device) * self.logit_std
                 + self.logit_mean)
            ab = torch.sigmoid(z)
        else:
            assert self.time_sampling == "uniform", self.time_sampling
            ab = torch.rand(n, 2, generator=generator, device=device)
        t, r = ab.max(dim=1).values, ab.min(dim=1).values
        keep = torch.rand(n, generator=generator, device=device) < self.ratio_rt
        return t, torch.where(keep, r, t)

    # -- training ------------------------------------------------------------

    def train_loss(self, model_fn: DenoiseFn, x0: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                   dropped: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mean(w * ||u - sg(v - (t - r) du/dt)||^2)`` (JAX
        ``MeanFlow.train_loss``, ``diffusion/meanflow.py:141-213``).

        ``t`` ``[N, 2]`` replaces the draw of (t, r), ``noise`` that of eps
        and ``dropped`` ``[N]`` (bool) the CFG-integrated label dropout; the
        draws otherwise come in that order from ``generator``. The time
        packing sits inside the differentiated function, so the chain rule
        through the scaled time input is the JVP's."""
        n, device = x0.shape[0], x0.device
        if t is None:
            t, r = self._sample_tr(n, generator, device)
        else:
            t = t.to(device=device, dtype=torch.float32)
            t, r = t[:, 0], t[:, 1]
        eps = (noise.to(device=device, dtype=torch.float32) if noise is not None
               else torch.randn(x0.shape, generator=generator, device=device))
        x0f = x0.float()
        tb = t[:, None, None, None]
        z = ((1.0 - tb) * x0f + tb * eps).to(x0.dtype)
        v = eps - x0f  # the straight-line velocity dz/dt

        v_tilde = v
        if self.cfg_omega != 1.0:
            assert y is not None and self.cfg_null_index is not None, (
                "cfg_omega != 1 is CFG-integrated training: it needs class labels and "
                "cfg_null_index (the null row)")
            y_null = torch.full_like(y, self.cfg_null_index)
            if dropped is None:
                dropped = torch.rand(n, generator=generator, device=device) < self.cfg_dropout
            dropped = dropped.to(device=device, dtype=torch.bool)
            y = torch.where(dropped, y_null, y)
            with torch.no_grad():  # the model's own marginal velocity, stop-graded
                u_null = model_fn(z, self.pack_time(t, t), cond, y_null).float()
            v_tilde = self.cfg_omega * v + (1.0 - self.cfg_omega) * u_null
            # dropped samples train the unconditional field: plain v
            v_tilde = torch.where(dropped[:, None, None, None], v, v_tilde)

        def u_fn(zz, tt, rr):
            return model_fn(zz, self.pack_time(tt, rr), cond, y)

        u, dudt = torch.func.jvp(u_fn, (z, t, r),
                                 (v_tilde.to(z.dtype), torch.ones_like(t), torch.zeros_like(r)))
        target = (v_tilde - (t - r)[:, None, None, None] * dudt.float()).detach()
        sq = ((u.float() - target) ** 2).mean(dim=(1, 2, 3))  # per sample
        if self.adaptive_p:
            w = 1.0 / (sq.detach() + self.adaptive_c) ** self.adaptive_p
            return (w * sq).mean()
        return sq.mean()

    # -- sampling ------------------------------------------------------------

    def sample(self, model_fn: DenoiseFn, n_samples: int, *, device,
               generator: Optional[torch.Generator] = None, num_steps: int = 1,
               method: str = "euler", cond: Optional[torch.Tensor] = None,
               y: Optional[torch.Tensor] = None, x_T: Optional[torch.Tensor] = None,
               guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
               guidance_interval=None, uncond=None, y_uncond=None,
               mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
               log_every=None, dtype: torch.dtype = torch.float32, model_state=None,
               start_index: Optional[int] = None,
               noise_fn: Optional[NoiseFn] = None) -> DiffusionOutput:
        """Segment-wise average-velocity sampling (JAX ``MeanFlow.sample``,
        ``diffusion/meanflow.py:217-307``): on the grid ``t_i`` from
        ``start / num_steps`` down to 0 (:func:`~eo_diffusion_torch.diffusion.
        flow.time_grid`), ``x <- x - (t_i - t_{i+1}) u(x, t_{i+1}, t_i)``.

        ``method`` is there for the call surface of ``FlowMatching.sample``;
        anything but "euler" raises. CFG (``guidance_scale`` with ``uncond``
        or ``y_uncond``, the rescale, the interval at ``t_i``), the stateful
        denoiser, ``mask``/``x0`` (the known region put back on the straight
        path before each step with ``noise_fn(i, "mask")``'s draw, x0 pasted
        in at the end), ``start_index`` and ``log_every`` are the flow
        sampler's."""
        if method != "euler":
            raise ValueError(f"MeanFlow integrates its own average-velocity displacement; "
                             f"method={method!r} does not apply (use euler)")
        if mask is not None:
            assert x0 is not None, "inpainting requires x0 (known image)"
            mask, x0 = mask.float(), x0.float()
        shape = (n_samples, self.image_size, self.image_size, self.in_channels)
        x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
             else torch.randn(shape, generator=generator, device=device))
        start = num_steps if start_index is None else int(start_index)
        assert 1 <= start <= num_steps, (
            f"start_index {start_index} outside the {num_steps}-interval grid")
        grid = time_grid(start / num_steps, start + 1)
        ts = torch.as_tensor(grid, device=device)
        state = model_state
        frames = []
        for i in range(start):
            t_i, t_next = ts[i], ts[i + 1]
            if mask is not None:
                eps = _draw(noise_fn, generator, i, "mask", shape, device)
                x = mask * ((1.0 - t_i) * x0 + t_i * eps) + (1.0 - mask) * x
            tt = self.pack_time(t_i.expand(n_samples), t_next.expand(n_samples))
            u, state = call_guided(
                model_fn, x.to(dtype), tt, cond, y, uncond=uncond, y_uncond=y_uncond,
                guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
                guidance_interval=guidance_interval, noise_frac=float(grid[i]),
                state=state, i=i)
            x = x - (t_i - t_next) * u.float()
            log_frames(frames, x, i, log_every, dtype)
        if mask is not None:
            x = mask * x0 + (1.0 - mask) * x
        return DiffusionOutput(x=x, intermediates=stack_frames(frames))
