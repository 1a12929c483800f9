"""DeepCache accelerated sampling (Ma et al., arXiv:2312.00858), in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/deepcache.py``. Adjacent
diffusion steps produce nearly the same deep UNet features, so the deep
branch (the downsampled levels, the middle block and, in the clouds UNet,
every attention block) runs only every ``refresh_every`` steps; in between
only the full-resolution shallow blocks run, with the cached deep feature
spliced in (:meth:`~eo_diffusion_torch.models.unet.UNet.forward`'s
``deep_cache`` / ``return_deep``). Where the JAX package picks the branch with
``lax.cond`` inside its scan, this is a Python branch on ``i %
refresh_every``.

Usage::

    fn, state0 = deepcache_model_fn(unet, refresh_every=3)
    out = diffusion.ddim_sample(fn, n, device=dev, num_steps=50, model_state=state0)

Under classifier-free guidance the samplers double the batch before the
stateful call, so the cached feature is the doubled batch's, as the JAX CLI
builds it (``ex_b = bsz * (2 if gkw else 1)``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

__all__ = ["deepcache_model_fn"]


def deepcache_model_fn(model: nn.Module, refresh_every: int = 2) -> Tuple[Callable, torch.Tensor]:
    """A stateful denoiser for the samplers' ``model_state=``.

    Returns ``(fn, state0)``: ``fn(x, t, cond, y, state, i) -> (out,
    state)`` runs the full UNet and returns its deep feature as the new
    state when ``i % refresh_every == 0``, and otherwise the shallow blocks
    on the cached ``state``, split at the UNet's default depth (its
    full-resolution level). Every sampler starts at ``i = 0``, which
    refreshes, so ``state0`` (an empty placeholder, where the JAX package
    builds zeros of the feature's shape) is never read.
    """
    assert refresh_every >= 1, refresh_every

    def fn(x, t, cond, y, state, i):
        if i % refresh_every == 0:
            return model(x, t, cond=cond, y=y, return_deep=True)
        return model(x, t, cond=cond, y=y, deep_cache=state), state

    return fn, torch.empty(0)
