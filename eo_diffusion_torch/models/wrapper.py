"""Conditioning-key dispatch (counterpart of ``eo_diffusion_tpu/models/wrapper.py``).

The Lightning path's ``DiffusionWrapper`` (reference
``diffusion/model_pl.py:189-215``) as a uniform ``(x, t, conditioning) ->
prediction`` adapter that routes named conditioning inputs to the
backbone's mechanisms:

* ``None``        -- unconditional
* ``"concat"``    -- channel-concat tensors (``c_concat``)
* ``"crossattn"`` -- context tokens to cross-attention (``c_crossattn``,
                     concatenated along the token axis; a UNet built with
                     ``context_dim > 0``)
* ``"adm"``       -- class labels to the embedding (``c_adm``)
* ``"hybrid"``    -- concat and cross-attention together, ``c_adm`` to the
                     class embedding when present
* ``"spade"``     -- the segmap of a :class:`SpadeUNet` (through ``cond``)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

__all__ = ["ConditioningWrapper"]

_KEYS = (None, "concat", "crossattn", "adm", "hybrid", "spade")


class ConditioningWrapper:
    """Wraps a backbone into ``fn(x, t, conditioning)``. ``conditioning`` is a
    dict that may hold ``c_concat`` (a list or a tensor, concatenated along
    channels), ``c_crossattn`` (a list or an ``[N, tokens, dim]`` tensor,
    concatenated along tokens) and ``c_adm`` (class labels)."""

    def __init__(self, model: nn.Module, conditioning_key: Optional[str] = None):
        assert conditioning_key in _KEYS, conditioning_key
        self.model = model
        self.conditioning_key = conditioning_key

    @staticmethod
    def _cat(c, dim: int = -1):
        if c is None:
            return None
        if isinstance(c, (list, tuple)):
            return torch.cat(list(c), dim=dim)
        return c

    def __call__(self, x: torch.Tensor, t: torch.Tensor,
                 conditioning: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        key = self.conditioning_key
        conditioning = conditioning or {}
        cond = self._cat(conditioning.get("c_concat"), dim=-1)
        ctx = self._cat(conditioning.get("c_crossattn"), dim=1)  # the token axis
        y = conditioning.get("c_adm")
        if key is None:
            return self.model(x, t)
        if key in ("concat", "spade"):
            return self.model(x, t, cond=cond)
        if key == "crossattn":
            return self.model(x, t, context=ctx)
        if key == "adm":
            return self.model(x, t, y=y)
        if key == "hybrid":
            return self.model(x, t, cond=cond, context=ctx, y=y)
        raise ValueError(key)
