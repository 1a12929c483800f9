"""Classifier guidance (Dhariwal & Nichol 2021) for the samplers, in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/classifier_guidance.py``: a
noisy-image classifier (:class:`~eo_diffusion_torch.models.encoder_unet.EncoderUNet`)
steers the reverse process through its input gradient,

    eps'(x_t, t) = eps(x_t, t) - sqrt(1 - acp_t) * s * grad_x log p(y | x_t)

(the eps-space form of adding ``s * grad log p(y|x)`` to the score). Wrap the
denoiser and pass the result to ``ddpm_sample`` / ``ddim_sample`` /
``dpm_sample`` / ``unipc_sample`` unchanged. UniPC evaluates the model at
fractional timesteps of its continuous-time grid; there ``sqrt(1 - acp_t)``
is the VP sigma at that node (:func:`noise_std`), where the JAX package's
table lookup fails.

The samplers run under ``torch.inference_mode()`` in the CLIs, so the
gradient is taken in ``torch.inference_mode(False)`` with grad enabled, on
copies of x, t and y made there: a tensor made in inference mode cannot be
saved for the backward. On the card the classifier's forward then runs the
attention kernel with its row logsumexp and the GroupNorm kernel, and the
input gradient their backward kernels. Freeze the classifier's parameters
(``requires_grad_(False)``) so that the backward computes no weight
gradient.
"""

from __future__ import annotations

from typing import Callable

import torch

from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion

__all__ = ["classifier_guided", "log_prob_grad", "noise_std"]


def noise_std(diffusion: GaussianDiffusion, t: torch.Tensor) -> torch.Tensor:
    """``sqrt(1 - acp_t)`` per sample, broadcast to NHWC, float32. An integer
    t reads the schedule's table. A fractional t (UniPC's nodes) takes
    lambda = log(alpha / sigma) linearly interpolated in the discrete lambda
    table, the inverse of how ``unipc.continuous_time_tables`` places its
    nodes, and sigma = sqrt(sigmoid(-2 lambda)): the sigma UniPC itself uses
    there."""
    if not t.is_floating_point():
        return diffusion._bcast("sqrt_one_minus_alphas_cumprod", t)
    sched = diffusion.schedule
    sa, so = (torch.as_tensor(a, dtype=torch.float64, device=t.device).clamp_min(1e-20)
              for a in (sched.sqrt_alphas_cumprod, sched.sqrt_one_minus_alphas_cumprod))
    lam = sa.log() - so.log()
    last = sched.timesteps - 1
    tt = t.double().clamp(0, last)
    i0 = tt.floor().long().clamp(max=max(last - 1, 0))
    w = tt - i0
    lam_t = lam[i0] * (1 - w) + lam[(i0 + 1).clamp(max=last)] * w
    return torch.sigmoid(-2 * lam_t).sqrt().float()[:, None, None, None]


def log_prob_grad(classifier_fn: Callable, x: torch.Tensor, t: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """``grad_x sum_i log_softmax(classifier_fn(x, t))[i, y_i]``, float32,
    x's shape; callable inside ``torch.inference_mode()``."""
    with torch.inference_mode(False), torch.enable_grad():
        xg = x.detach().float().clone().requires_grad_(True)
        logits = classifier_fn(xg, t.clone())
        logp = torch.log_softmax(logits.float(), dim=-1)
        selected = logp.gather(1, y.clone().long()[:, None]).sum()
        (grad,) = torch.autograd.grad(selected, xg)
    return grad


def classifier_guided(diffusion: GaussianDiffusion, model_fn: Callable,
                      classifier_fn: Callable, y: torch.Tensor,
                      scale: float = 1.0) -> Callable:
    """Wrap ``model_fn(x, t, cond, y)`` with classifier gradients toward the
    labels ``y`` ``[N]``. ``classifier_fn(x_t, t) -> logits [N, classes]``.
    The denoiser must predict eps, as the JAX package asserts."""
    assert diffusion.objective == "eps", (
        "classifier guidance wrapper currently assumes an eps-objective model")

    def guided(x, t, cond, yy):
        eps = model_fn(x, t, cond, yy)
        grad = log_prob_grad(classifier_fn, x, t, y)
        return eps - noise_std(diffusion, t) * scale * grad.to(eps.dtype)

    return guided
