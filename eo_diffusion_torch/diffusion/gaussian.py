"""Gaussian diffusion: the training loss, DDPM (with RePaint) and DDIM
samplers in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/gaussian.py``:

* ``train_loss``: the objective-MSE loss (reference ``EODiffusion.forward``,
  model.py:38-44, plus the x0/v objectives and the p2, min-SNR and VLB
  reweightings), with ``training_tuple`` / ``training_weight`` as its
  decomposition;
* ``EODiffusion`` (reference ``diffusion/model.py:12-150``): cosine-beta
  DDPM, ancestral sampling with optional x0 clipping and RePaint-"sum"
  masked conditioning (``model.py:58-60``), plus RePaint jumps
  (arXiv:2201.09865);
* ``DDIMSampler`` (reference ``diffusion/ddim.py:11-207``): strided
  deterministic / eta-stochastic sampling with mask inpainting;
* the guidance points every sampler shares: classifier-free guidance by
  batch doubling (:func:`cfg_double_inputs`, :func:`cfg_combine` with the
  CFG-rescale of arXiv:2305.08891), limited-interval guidance
  (:func:`interval_scale`, arXiv:2404.07724) and Imagen dynamic
  thresholding (:func:`apply_dynamic_threshold`, arXiv:2205.11487);
* stateful denoisers ``fn(x, t, cond, y, state, i) -> (out, state)``
  (``model_state=``, DeepCache), and DPM-Solver++ / UniPC as methods
  (``diffusion/dpm_solver.py``, ``diffusion/unipc.py``).

The reverse loops are plain Python loops over the steps. x_t is carried in
float32 and only the model input is cast to ``dtype`` (per-step bf16
rounding accumulates over the chain). Random draws come from an explicit
``torch.Generator``; ``noise_fn(i, role)`` replaces them in the samplers and
``t=`` / ``noise=`` in ``train_loss``, so tests can feed the JAX package's
draws. All tensors are NHWC. Self-conditioning (``self_condition=True``,
arXiv:2208.04202) appends the model's own clamped x0 estimate to the cond
channels; ``log_every=k`` keeps every k-th intermediate x as
``DiffusionOutput.intermediates`` (JAX ``_log_frame``); ``x0_proj`` is
DDIM's per-step x0 projection (DDNM, ``diffusion/inverse.py``); and
:meth:`GaussianDiffusion.interpolate` lerps two images in noise space.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from eo_diffusion_torch.core.schedules import (
    DDIMSchedule,
    DiffusionSchedule,
    make_ddim_schedule,
    make_schedule,
)

__all__ = ["GaussianDiffusion", "DiffusionOutput", "repaint_op_sequence", "cfg_double_inputs",
           "guided_combine", "cfg_combine", "interval_scale", "noise_level",
           "apply_dynamic_threshold"]

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


def cfg_double_inputs(x, t, cond, y, uncond=None, y_uncond=None, guidance_scale: float = 1.0):
    """Classifier-free-guidance batch doubling, the one policy point of every
    sampler (JAX ``gaussian.cfg_double_inputs``): ``[uncond, cond]`` order.

    Image-CFG (``uncond``, reference ddim.py:177-181) takes precedence over
    label-CFG (``y_uncond``, the null-class labels) when both are given.
    Returns ``(x_in, t_in, c_in, y_in, doubled)``; when ``doubled`` is False
    the inputs pass through untouched and no combine is needed.
    """
    use_c = uncond is not None and guidance_scale != 1.0
    use_y = (not use_c) and y_uncond is not None and guidance_scale != 1.0
    if not (use_c or use_y):
        return x, t, cond, y, False
    x_in, t_in = torch.cat([x, x]), torch.cat([t, t])
    if use_c:
        c_in = torch.cat([uncond.to(cond.dtype), cond])
        y_in = None if y is None else torch.cat([y, y])
    else:
        c_in = None if cond is None else torch.cat([cond, cond])
        y_in = torch.cat([y_uncond.to(y.dtype), y])
    return x_in, t_in, c_in, y_in, True


def guided_combine(e_u: torch.Tensor, e_c: torch.Tensor, guidance_scale,
                   guidance_rescale: float = 0.0) -> torch.Tensor:
    """``e_u + s * (e_c - e_u)`` (reference ddim.py:180), the combine of CFG
    and of autoguidance (``e_u`` the bad model's prediction there).
    ``guidance_rescale`` (phi of arXiv:2305.08891 §3.4) mixes the guided
    prediction back toward ``e_c``'s per-sample std: ``phi * guided * std_c /
    std_g + (1 - phi) * guided``, with the population std (``correction=0``,
    as ``jnp.std``)."""
    guided = e_u + guidance_scale * (e_c - e_u)
    if guidance_rescale:
        dims = tuple(range(1, guided.ndim))
        std_c = torch.std(e_c, dim=dims, keepdim=True, correction=0)
        std_g = torch.std(guided, dim=dims, keepdim=True, correction=0)
        fixed = guided * (std_c / torch.clamp(std_g, min=1e-8))
        guided = guidance_rescale * fixed + (1.0 - guidance_rescale) * guided
    return guided


def cfg_combine(out: torch.Tensor, guidance_scale, guidance_rescale: float = 0.0) -> torch.Tensor:
    """Guided combine of a batch-doubled ``[uncond, cond]`` model output
    (:func:`guided_combine`)."""
    e_u, e_c = out.chunk(2, dim=0)
    return guided_combine(e_u, e_c, guidance_scale, guidance_rescale)


def interval_scale(guidance_scale: float, noise_frac, interval):
    """Limited-interval guidance (Kynkäänniemi et al., arXiv:2404.07724): the
    scale while the normalized noise level ``noise_frac`` (1 = pure noise:
    t/(T-1) on DDPM chains, t on the flow ODE) lies in ``interval = (lo,
    hi)``, 1 (the plain cond branch) outside. The level is compared in
    float32, as the JAX package does. A Python ``noise_frac`` (the samplers
    know their step on the host) gives a Python float; a tensor (a wrapper
    that sees only the model's ``t``) gives a 0-dim float32 tensor, so the
    decision stays on the device."""
    if interval is None:
        return guidance_scale
    lo, hi = (float(np.float32(v)) for v in interval)
    if torch.is_tensor(noise_frac):
        frac = noise_frac.to(torch.float32)
        inside = (frac >= lo) & (frac <= hi)
        return torch.where(inside, torch.tensor(guidance_scale, dtype=torch.float32,
                                                device=frac.device),
                           torch.tensor(1.0, dtype=torch.float32, device=frac.device))
    frac = float(np.float32(noise_frac))
    return guidance_scale if lo <= frac <= hi else 1.0


def noise_level(t, denom):
    """``t / denom`` in float32 as the JAX package's compiled samplers compute
    it: ``t`` times the float32 reciprocal of the constant ``denom`` (XLA's
    rewrite of a division by a constant; the correctly rounded quotient parts
    from it in the last bit at about one t in six, which moves
    :func:`interval_scale`'s gate where a level lies on its edge). A tensor
    ``t`` gives a float32 tensor, anything else a Python float."""
    recip = np.float32(1.0) / np.float32(denom)
    if torch.is_tensor(t):
        return t.float() * float(recip)
    return float(np.float32(t) * recip)


def apply_dynamic_threshold(x0: torch.Tensor, percentile: float) -> torch.Tensor:
    """Imagen dynamic thresholding (arXiv:2205.11487 §2.3): per sample
    ``s = max(quantile_p(|x0|), 1)``, then x0 clipped to ``[-s, s]`` and
    divided by ``s``. The quantile is ``jnp.quantile``'s "linear" one (the
    order statistics at ``floor`` and ``ceil`` of ``p * (n - 1)``, linearly
    interpolated), taken with ``torch.kthvalue``: ``torch.quantile`` refuses
    rows above 2^24 elements."""
    assert 0.5 < percentile <= 1.0, percentile
    flat = x0.reshape(x0.shape[0], -1).float().abs()
    n = flat.shape[1]
    pos = np.float32(percentile) * np.float32(n - 1)  # in float32, as jnp.quantile
    lo, hi = min(int(math.floor(pos)), n - 1), min(int(math.ceil(pos)), n - 1)
    w = float(pos - np.float32(lo))
    v_lo = torch.kthvalue(flat, lo + 1, dim=1).values
    v_hi = torch.kthvalue(flat, hi + 1, dim=1).values if hi != lo else v_lo
    s = v_lo * float(np.float32(1.0) - np.float32(w)) + v_hi * w
    s = torch.clamp(s, min=1.0).reshape((-1,) + (1,) * (x0.ndim - 1))
    x0 = x0.float()
    return torch.maximum(torch.minimum(x0, s), -s) / s


def call_guided(model_fn, x, t, cond, y, *, uncond=None, y_uncond=None,
                guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
                guidance_interval=None, noise_frac=0.0, state=None, i: int = 0):
    """One model evaluation through the shared guidance points: the CFG
    doubling, the (stateful when ``state`` is not None) call
    ``model_fn(x, t, cond, y[, state, i])`` and the combine at the interval's
    scale. Returns ``(out, state)``."""
    x_in, t_in, c_in, y_in, doubled = cfg_double_inputs(x, t, cond, y, uncond, y_uncond,
                                                        guidance_scale)
    if state is None:
        out = model_fn(x_in, t_in, c_in, y_in)
    else:
        out, state = model_fn(x_in, t_in, c_in, y_in, state, i)
    if doubled:
        out = cfg_combine(out, interval_scale(guidance_scale, noise_frac, guidance_interval),
                          guidance_rescale)
    return out, state


@dataclasses.dataclass(frozen=True)
class DiffusionOutput:
    """Sampling result: the final x and, with ``log_every``, the logged
    frames ``[K, N, H, W, C]``."""

    x: torch.Tensor
    intermediates: Optional[torch.Tensor] = None


def log_frames(frames: list, x: torch.Tensor, i: int, k: Optional[int], dtype) -> None:
    """Keep x as frame ``i // k`` when ``i % k == 0`` (JAX ``_log_frame``):
    ceil(steps / k) frames, each the x after that step, in ``dtype``."""
    if k and i % k == 0:
        frames.append(x.to(dtype))


def stack_frames(frames: list) -> Optional[torch.Tensor]:
    return torch.stack(frames) if frames else None


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
    # p2 loss reweighting (arXiv:2204.00227): (k + SNR)^-gamma; gamma 0 = off
    p2_loss_weight_k: float = 1.0
    p2_loss_weight_gamma: float = 0.0
    # min-SNR-gamma weighting (arXiv:2303.09556); 0 = off
    min_snr_gamma: float = 0.0
    # self-conditioning (arXiv:2208.04202): the denoiser also sees its own x0
    # estimate, appended as extra cond channels (the UNet's in_channels must
    # budget for them)
    self_condition: bool = False
    # CompVis-style VLB auxiliary loss: total = L_simple + elbo_weight *
    # E_t[lvlb_w(t) * err(t)]; 0 = off
    elbo_weight: float = 0.0
    _tables: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @classmethod
    def create(cls, timesteps: int = 1000, image_size: int = 64, in_channels: int = 3,
               cond_type: Optional[str] = None, schedule: str = "cosine_eo",
               objective: str = "eps", p2_loss_weight_k: float = 1.0,
               p2_loss_weight_gamma: float = 0.0, self_condition: bool = False,
               elbo_weight: float = 0.0, zero_terminal_snr: bool = False,
               min_snr_gamma: float = 0.0) -> "GaussianDiffusion":
        assert objective in ("eps", "x0", "v"), objective
        # with SNR(T) = 0 the model sees pure noise at the terminal step, so
        # eps-prediction degenerates; the rescale is only sound under v
        assert not zero_terminal_snr or objective == "v", (
            "zero_terminal_snr requires objective='v' (at SNR=0 the eps/x0 "
            "parameterizations cannot recover x0; arXiv:2305.08891 §2.2)")
        return cls(schedule=make_schedule(timesteps, schedule,
                                          zero_terminal_snr=zero_terminal_snr),
                   image_size=image_size, in_channels=in_channels,
                   cond_type=cond_type, objective=objective,
                   p2_loss_weight_k=p2_loss_weight_k,
                   p2_loss_weight_gamma=p2_loss_weight_gamma,
                   min_snr_gamma=min_snr_gamma, self_condition=self_condition,
                   elbo_weight=elbo_weight)

    def _with_self_cond(self, cond, x_sc):
        """Append the self-conditioning channels after any existing cond."""
        if cond is None:
            return x_sc
        return torch.cat([cond.to(x_sc.dtype), x_sc], dim=-1)

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

    # -- training ---------------------------------------------------------

    def _target(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Regression target per objective; v = a*eps - s*x0 with
        a = sqrt(acp), s = sqrt(1-acp) (Salimans & Ho 2022)."""
        if self.objective == "eps":
            return noise
        if self.objective == "x0":
            return x0
        return (self._bcast("sqrt_alphas_cumprod", t) * noise
                - self._bcast("sqrt_one_minus_alphas_cumprod", t) * x0)

    def _p2_weight(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        if self.p2_loss_weight_gamma == 0.0:
            return None
        acp = self._table("alphas_cumprod", t.device)[t]
        snr = acp / (1.0 - acp)
        return (self.p2_loss_weight_k + snr) ** (-self.p2_loss_weight_gamma)

    def _min_snr_weight(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """min-SNR-gamma weight per sample (arXiv:2303.09556 §3.2), in the
        parameterization actually trained (the paper states weights w.r.t.
        the x0 loss; dividing by the objective's SNR power converts)."""
        if self.min_snr_gamma == 0.0:
            return None
        acp = self._table("alphas_cumprod", t.device)[t]
        snr = acp / torch.clamp(1.0 - acp, min=1e-12)
        clipped = torch.clamp(snr, max=self.min_snr_gamma)
        if self.objective == "eps":
            return clipped / torch.clamp(snr, min=1e-12)
        if self.objective == "v":
            return clipped / (snr + 1.0)
        return clipped  # x0

    def _lvlb_weights(self, device) -> torch.Tensor:
        """CompVis lvlb weights for the eps parameterization
        (ddpm.py:164-174): beta^2 / (2 sigma_posterior^2 alpha (1-acp)),
        with the t=0 term copied from t=1 to avoid the 0/0."""
        key = ("lvlb", str(device))
        if key not in self._tables:
            betas, alphas = self._table("betas", device), self._table("alphas", device)
            acp = self._table("alphas_cumprod", device)
            acp_prev = self._table("alphas_cumprod_prev", device)
            posterior_var = betas * (1.0 - acp_prev) / (1.0 - acp)
            w = betas**2 / (2.0 * torch.clamp(posterior_var, min=1e-20) * alphas * (1.0 - acp))
            w[0] = w[1]
            self._tables[key] = w
        return self._tables[key]

    def _draw_t_noise(self, x0, generator, t, noise):
        n = x0.shape[0]
        if t is None:
            t = torch.randint(0, self.timesteps, (n,), generator=generator, device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                                dtype=x0.dtype)
        return t.to(device=x0.device, dtype=torch.long), noise.to(x0.dtype)

    def training_tuple(self, x0: torch.Tensor, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       t: Optional[torch.Tensor] = None):
        """Draw one training instance ``(x_t, t, target)`` such that
        ``mean(w * (model(x_t, t) - target)^2)`` with ``w`` from
        :meth:`training_weight` equals :meth:`train_loss`."""
        assert not self.self_condition, (
            "training_tuple is a plain-MSE decomposition; self-conditioning "
            "needs the two-pass train_loss")
        t, noise = self._draw_t_noise(x0, generator, t, noise)
        x_t = self.q_sample(x0, t, noise)
        return x_t, t, self._target(x0.float(), t, noise.float())

    def training_weight(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """Per-sample loss weight [N]: the reweightings are per-sample scalars
        in t and compose multiplicatively, ``w = p2 * min_snr * (1 +
        elbo_weight * lvlb)``. None when no reweighting is configured."""
        w = None
        for part in (self._p2_weight(t), self._min_snr_weight(t)):
            if part is not None:
                w = part if w is None else w * part
        if self.elbo_weight > 0.0:
            vlb = 1.0 + self.elbo_weight * self._lvlb_weights(t.device)[t]
            w = vlb if w is None else w * vlb
        return w

    def train_loss(self, model_fn: DenoiseFn, x0: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None,
                   self_cond_coin: Optional[bool] = None) -> torch.Tensor:
        """Objective-MSE training loss (a float32 scalar).

        The reference's active path is epsilon-MSE (model.py:38-44 +
        train.py:86,117); the "x0"/"v" objectives and p2 reweighting follow
        the vendored lucidrains trainer's options. The timesteps and the noise
        are drawn from ``generator`` unless given: ``noise`` is the fixed eps
        per sample of the reference's ``EODiffusion.forward``, ``t`` lets a
        test feed another framework's draw. The error and the target are
        float32 whatever the model computes in.

        Self-conditioning: half the time (``self_cond_coin``, drawn from
        ``generator`` unless given) the model sees its own x0 estimate from a
        no-grad pass with zero self-cond channels, else zeros. The port runs
        that first pass only when the coin says so; the JAX package always
        runs it and masks its result, which gives the same loss.
        """
        t, noise = self._draw_t_noise(x0, generator, t, noise)
        x_t = self.q_sample(x0, t, noise).to(x0.dtype)
        if self.self_condition:
            if self_cond_coin is None:
                self_cond_coin = bool(torch.rand((), generator=generator,
                                                 device=x0.device) < 0.5)
            x_sc = torch.zeros_like(x_t)
            if self_cond_coin:
                with torch.no_grad():
                    pred0 = model_fn(x_t, t, self._with_self_cond(cond, x_sc), y)
                    x_sc = self._to_eps_x0(pred0, x_t, t)[1].to(x_t.dtype)
            cond = self._with_self_cond(cond, x_sc)
        pred = model_fn(x_t, t, cond, y)
        target = self._target(x0.float(), t, noise.float())
        err = (pred.float() - target) ** 2
        for w in (self._p2_weight(t), self._min_snr_weight(t)):
            if w is not None:
                err = err * w[:, None, None, None]
        loss = err.mean()
        if self.elbo_weight > 0.0:
            per = err.mean(dim=(1, 2, 3))
            loss = loss + self.elbo_weight * (self._lvlb_weights(t.device)[t] * per).mean()
        return loss

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

    def _reverse_step(self, pred: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor,
                      noise: torch.Tensor, clip: bool, dynamic_threshold=None):
        """One ancestral reverse step from the model output ``pred``.
        ``clip=False``: posterior mean from the predicted noise (reference
        model.py:101-122); ``clip=True``: clamp the predicted x0 to [-1, 1]
        and use the q-posterior mean (model.py:125-150);
        ``dynamic_threshold`` swaps the clamp for
        :func:`apply_dynamic_threshold` on the same path. Returns
        ``(x_{t-1}, x0_pred)``."""
        eps, x0_pred = self._to_eps_x0(pred.float(), x_t, t)
        x_t = x_t.float()
        alpha_t = self._bcast("alphas", t)
        acp_t = self._bcast("alphas_cumprod", t)
        acp_prev = self._bcast("alphas_cumprod_prev", t)
        beta_t = self._bcast("betas", t)
        if clip or dynamic_threshold is not None:
            x0_pred = (apply_dynamic_threshold(x0_pred, dynamic_threshold)
                       if dynamic_threshold is not None else torch.clamp(x0_pred, -1.0, 1.0))
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
                    guidance_rescale: float = 0.0, guidance_interval=None,
                    y_uncond=None, log_every=None, model_state=None) -> DiffusionOutput:
        """Ancestral DDPM sampling (reference ``EODiffusion.sampling``, model.py:47-75).

        RePaint-"sum": when ``cond_type == "sum"``, ``cond`` is (gt | mask);
        before every reverse step the known region is re-noised to level t
        and composited in, with the same noise that drives the step
        (model.py:58-60). ``jump_len``/``jump_n`` add RePaint resampling.
        ``noise_fn(i, "step")`` supplies op ``i``'s noise (default: drawn
        from ``generator``); ``x_T`` the starting noise.

        Guidance is label-CFG only (``y_uncond``, the null-class labels), as
        in the JAX package: its DDPM chain has no image-CFG path.
        ``model_state``: a stateful denoiser ``fn(x, t, cond, y, state, i)
        -> (out, state)`` (DeepCache); ``i`` counts ops, RePaint's forward
        ops included. ``log_every=k``: the x after every k-th op as
        ``intermediates``. Self-conditioning carries the clamped x0 estimate
        of each reverse step into the next.
        """
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
        t_denom = max(self.timesteps - 1, 1)
        state = model_state
        x_sc = torch.zeros(shape, dtype=dtype, device=device) if self.self_condition else None
        frames = []
        for i, (t_scalar, is_rev) in enumerate(zip(t_ops.tolist(), rev_ops.tolist())):
            noise = _draw(noise_fn, generator, i, "step", shape, device)
            t = torch.full((n_samples,), t_scalar, dtype=torch.long, device=device)
            if is_rev:
                if gt is not None:
                    x = mask * self.q_sample(gt, t, noise) + (1.0 - mask) * x
                c = self._with_self_cond(cond, x_sc) if self.self_condition else cond
                pred, state = call_guided(
                    model_fn, x.to(dtype), t, c, y, y_uncond=y_uncond,
                    guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
                    guidance_interval=guidance_interval,
                    noise_frac=noise_level(t_scalar, t_denom),
                    state=state, i=i)
                x, x0_pred = self._reverse_step(pred, x, t, noise, clip, dynamic_threshold)
                if self.self_condition:  # the carried estimate is clamped
                    x_sc = torch.clamp(x0_pred, -1.0, 1.0).to(dtype)
            else:  # RePaint forward op: one q-step up to level t (eq. 9)
                beta_t = self._bcast("betas", t)
                x = torch.sqrt(1.0 - beta_t) * x + torch.sqrt(beta_t) * noise
            log_frames(frames, x, i, log_every, dtype)
        return DiffusionOutput(x=x, intermediates=stack_frames(frames))

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
                    guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
                    guidance_interval=None, uncond=None, y_uncond=None,
                    dynamic_threshold=None, log_every=None, model_state=None,
                    x0_proj=None) -> DiffusionOutput:
        """DDIM sampling (reference ``DDIMSampler``, ddim.py:57-207).

        * eta=0 is the deterministic DDIM ODE (no noise is drawn); eta=1 gives
          ancestral variance on the subsequence (arXiv:2010.02502 eq. 16).
        * ``mask``/``x0``: before each step the known region of x0 is
          re-noised to the current level and composited (ddim.py:145-148).
        * ``clip`` clamps pred_x0 to [-1, 1] and re-derives eps from it;
          ``dynamic_threshold`` (a percentile) does the same with
          :func:`apply_dynamic_threshold` in place of the clamp.
        * ``guidance_scale`` with ``uncond`` (image-CFG on the concat cond)
          or ``y_uncond`` (label-CFG), ``guidance_rescale`` and
          ``guidance_interval``: :func:`call_guided`, the noise level being
          t / (T - 1).
        * ``model_state``: a stateful denoiser ``fn(x, t, cond, y, state, i)
          -> (out, state)`` (DeepCache); ``i`` counts the steps run. Under
          CFG the doubled batch flows through it.
        * ``start_index``: run only the last ``start_index`` steps.
        * ``noise_fn(i, "mask" | "eta")`` supplies step ``i``'s draws.
        * ``x0_proj``: a projection of pred_x0 applied after the clip and the
          re-derived eps (DDNM's range-space replacement); the direction term
          keeps that eps (arXiv:2212.00490 Alg. 1).
        * ``log_every=k``: the x after every k-th step as ``intermediates``.
        """
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
        t_denom = max(self.timesteps - 1, 1)
        state = model_state
        x_sc = torch.zeros(shape, dtype=dtype, device=device) if self.self_condition else None
        frames = []
        for i, idx in enumerate(range(start - 1, -1, -1)):
            t_scalar = int(dd.timesteps[idx])
            t = torch.full((n_samples,), t_scalar, dtype=torch.long, device=device)
            if mask is not None:
                img_orig = self.q_sample(x0, t, _draw(noise_fn, generator, i, "mask",
                                                      shape, device))
                x = img_orig * mask + (1.0 - mask) * x
            c, u = cond, uncond
            if self.self_condition:
                c = self._with_self_cond(cond, x_sc)
                u = None if uncond is None else self._with_self_cond(uncond, x_sc)
            raw, state = call_guided(
                model_fn, x.to(dtype), t, c, y, uncond=u, y_uncond=y_uncond,
                guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
                guidance_interval=guidance_interval,
                noise_frac=noise_level(t_scalar, t_denom),
                state=state, i=i)
            xf = x.float()
            e_t, pred_x0 = self._to_eps_x0(raw, xf, t)
            if clip or dynamic_threshold is not None:
                pred_x0 = (apply_dynamic_threshold(pred_x0, dynamic_threshold)
                           if dynamic_threshold is not None
                           else torch.clamp(pred_x0, -1.0, 1.0))
                a = self._bcast("sqrt_alphas_cumprod", t)
                s = self._bcast("sqrt_one_minus_alphas_cumprod", t)
                e_t = (xf - a * pred_x0) / torch.clamp(s, min=1e-8)
            if x0_proj is not None:  # last, so that A(x0) = y holds exactly
                pred_x0 = x0_proj(pred_x0)
            a_prev, sigma_t = alphas_prev[idx], sigmas[idx]
            dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=0.0)) * e_t
            x = torch.sqrt(a_prev) * pred_x0 + dir_xt
            if eta != 0.0:
                x = x + sigma_t * _draw(noise_fn, generator, i, "eta", shape,
                                        device) * temperature
            if self.self_condition:
                x_sc = torch.clamp(pred_x0, -1.0, 1.0).to(dtype)
            log_frames(frames, x, i, log_every, dtype)
        return DiffusionOutput(x=x, intermediates=stack_frames(frames))

    def dpm_sample(self, model_fn: DenoiseFn, n_samples: int, **kw) -> DiffusionOutput:
        """DPM-Solver++ (:func:`~eo_diffusion_torch.diffusion.dpm_solver.dpm_solver_sample`)
        as a method, so every sampler shares the call surface and
        ``LatentDiffusion`` routes uniformly."""
        from eo_diffusion_torch.diffusion.dpm_solver import dpm_solver_sample

        return dpm_solver_sample(self, model_fn, n_samples, **kw)

    def unipc_sample(self, model_fn: DenoiseFn, n_samples: int, **kw) -> DiffusionOutput:
        """UniPC (:func:`~eo_diffusion_torch.diffusion.unipc.unipc_sample`) as a method."""
        from eo_diffusion_torch.diffusion.unipc import unipc_sample

        return unipc_sample(self, model_fn, n_samples, **kw)

    # -- interpolation ------------------------------------------------------

    def interpolate(self, model_fn: DenoiseFn, x1: torch.Tensor, x2: torch.Tensor,
                    lam: float = 0.5, t: Optional[int] = None, clip: bool = True,
                    dtype: torch.dtype = torch.float32, *,
                    generator: Optional[torch.Generator] = None,
                    noise_fn: Optional[NoiseFn] = None) -> DiffusionOutput:
        """Interpolate two images in noise space (JAX
        ``GaussianDiffusion.interpolate``; lucidrains
        denoising_diffusion_pytorch.py:638-651): q-sample both to level ``t``
        (default T-1), lerp the two with ``lam`` and run the ancestral chain
        down from t. ``noise_fn(0, "x1" | "x2")`` and ``noise_fn(i, "step")``
        replace the draws."""
        t = self.timesteps - 1 if t is None else int(t)
        assert 0 < t < self.timesteps, t
        assert x1.shape == x2.shape, (x1.shape, x2.shape)
        shape, device = tuple(x1.shape), x1.device
        tb = torch.full((shape[0],), t, dtype=torch.long, device=device)
        xt1 = self.q_sample(x1.float(), tb, _draw(noise_fn, generator, 0, "x1", shape, device))
        xt2 = self.q_sample(x2.float(), tb, _draw(noise_fn, generator, 0, "x2", shape, device))
        x = (1.0 - lam) * xt1 + lam * xt2
        for i, t_scalar in enumerate(range(t - 1, -1, -1)):
            noise = _draw(noise_fn, generator, i, "step", shape, device)
            tt = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
            x, _ = self._reverse_step(model_fn(x.to(dtype), tt, None, None), x, tt, noise, clip)
        return DiffusionOutput(x=x)
