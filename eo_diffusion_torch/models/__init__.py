"""Backbone families. Shared small helpers only; the models import lazily."""

import torch

__all__ = ["time_template"]


def time_template(model, n: int = 1, device=None) -> torch.Tensor:
    """A timestep placeholder in the model's time-input layout (JAX
    ``models.time_template``): ``[n]`` integer steps normally, ``[n, 2]``
    float32 for a dual-time (MeanFlow) backbone, whose time input packs (t,
    r): ``UNetConfig.dual_time`` / ``DiTConfig.dual_time``. ``model`` is a
    module (its ``.config``) or a config itself."""
    cfg = getattr(model, "config", None) or model
    if getattr(cfg, "dual_time", False):
        return torch.zeros((n, 2), dtype=torch.float32, device=device)
    return torch.zeros((n,), dtype=torch.long, device=device)
