"""Exponential moving average of model parameters over lists of tensors.

Counterpart of ``eo_diffusion_tpu/train/ema.py``: the reference's torch
``ExponentialMovingAverage`` (``script_utils/utils.py:56-67``, a
``swa_utils.AveragedModel`` wrapper) and the decay adjustment applied at its
call site (``train.py:70-73``). The shadow parameters stay on the model's
device and are updated in place with ``torch._foreach_*`` calls.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["adjusted_decay", "ema_update", "ema_update_every", "warmed_decay"]


def warmed_decay(decay: float, n_updates: int) -> float:
    """timm-style decay warmup: min(decay, (1 + n) / (10 + n)), in float32.

    Early updates average aggressively so the EMA tracks from the first
    steps instead of dragging initialization noise for a full 1/(1-decay)
    horizon.
    """
    n = torch.tensor(float(n_updates), dtype=torch.float32)
    return float(torch.minimum(torch.tensor(decay, dtype=torch.float32),
                               (1.0 + n) / (10.0 + n)))


def adjusted_decay(decay: float, batch_size: int, ema_steps: int, epochs: int) -> float:
    """The torchvision-style decay adjustment (reference train.py:70-72):

    alpha = min(1, (1 - decay) * batch_size * ema_steps / epochs);
    effective decay = 1 - alpha.
    """
    adjust = 1 * batch_size * ema_steps / epochs
    alpha = 1.0 - decay
    alpha = min(1.0, alpha * adjust)
    return 1.0 - alpha


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place (reference
    utils.py:64-65). The arithmetic is float32 whatever the shadow's dtype;
    the result is cast back to it."""
    ema_params, params = list(ema_params), list(params)
    d = float(torch.tensor(decay, dtype=torch.float32))
    one_minus = float(torch.tensor(1.0, dtype=torch.float32) - torch.tensor(d, dtype=torch.float32))
    if all(e.dtype == torch.float32 for e in ema_params):
        torch._foreach_mul_(ema_params, d)
        torch._foreach_add_(ema_params, [p.detach().float() for p in params], alpha=one_minus)
        return
    for e, p in zip(ema_params, params):
        e.copy_((d * e.float() + one_minus * p.detach().float()).to(e.dtype))


def ema_update_every(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                     decay: float, step: int, every: int) -> bool:
    """Update the EMA when ``step % every == 0`` (the reference cadence
    ``if global_steps % model_ema_steps == 0``, train.py:122-123), with
    ``step`` the counter before it is incremented. Returns whether it did."""
    if step % every != 0:
        return False
    ema_update(ema_params, params, decay)
    return True
