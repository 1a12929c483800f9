"""Perturbed-Attention Guidance (PAG, arXiv:2403.17377), in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/pag.py``. Guidance that needs
no extra training and no condition: the "bad" branch is the same model with
every self-attention map replaced by the identity
(:func:`~eo_diffusion_torch.ops.attention.identity_attention`), and the
prediction is pushed away from it, ``e + s * (e - e_perturbed)`` (paper
eq. 8). The perturbed call returns v at every attention site and launches no
attention kernel. It composes with CFG: the samplers double the batch
outside this wrapper, so the PAG delta applies to both rows.
"""

from __future__ import annotations

from typing import Callable

import torch

from eo_diffusion_torch.ops import attention as A

__all__ = ["pag_model_fn"]


def pag_model_fn(model_fn: Callable, pag_scale: float) -> Callable:
    """Wrap ``model_fn(x, t, cond, y) -> pred`` with the PAG combine (JAX
    ``pag_model_fn``). ``pag_scale`` 0 returns ``model_fn`` itself. When the
    prediction carries a learned-variance tail (twice x's channels) only
    its first half is guided; the tail passes through from the plain call.
    A backbone with no site routed through ``attention_from_qkv`` would make
    the two calls equal, so the wrapper raises when the perturbed call hit
    none."""
    if pag_scale == 0:
        return model_fn

    def fn(x, t, cond, y):
        pred = model_fn(x, t, cond, y)
        hits0 = A.identity_attention_hits()
        with A.identity_attention():
            pred_p = model_fn(x, t, cond, y)
        if A.identity_attention_hits() == hits0:
            raise ValueError(
                "pag_scale is a no-op on this backbone: no self-attention site routed "
                "through ops.attention.attention_from_qkv during the perturbed call (PAG "
                "perturbs only that dispatch). Use a UNet/DiT backbone with attention, "
                "or drop --pag_scale.")
        c = x.shape[-1]
        if pred.shape[-1] == 2 * c:  # learned-variance tail passes through
            e, tail = pred[..., :c], pred[..., c:]
            return torch.cat([e + pag_scale * (e - pred_p[..., :c]), tail], dim=-1)
        return pred + pag_scale * (pred - pred_p)

    return fn
