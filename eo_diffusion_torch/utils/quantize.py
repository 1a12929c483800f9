"""Weight-only int8 quantization for serving (counterpart of
``eo_diffusion_tpu/utils/quantize.py``).

Matrix and conv weights are stored as symmetric per-output-channel int8
with float32 scales and dequantized on every sampling call
(``serving/engine.py`` ``ServingConfig.int8``, ``cli.serve --int8``):
W8A16, the activations stay bf16 / float32.

The output channel is the *flax* layout's last axis, as in the JAX package:
a Dense kernel is ``[in, out]`` there (``[out, in]`` here), a conv ``[h, w,
in, out]`` (``[out, in, h, w]`` here). Each parameter is viewed in its flax
layout through the torch twin of its entry in ``weights.model_layout``
(``views``: parameter name -> ``weights._TWIN`` name), quantized over that
view's last axis and turned back, so int8 values and scales equal the JAX
package's leaf for leaf. A scale is stored in the torch layout, shaped to
broadcast against its weight. Leaves whose flax view has fewer than two
dimensions (biases, norm scales) pass through with a unit scale.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

__all__ = ["flax_views", "quantize_tree", "dequantize_tree", "quantized_bytes"]


def flax_views(module: torch.nn.Module) -> Dict[str, str]:
    """Parameter name -> the name of its torch flax-view transform
    (``weights.torch_transforms``), from ``weights.model_layout``."""
    from eo_diffusion_torch.weights import _TWIN, model_layout

    return {tname: _TWIN[inv] for _, tname, _, inv in model_layout(module)}


def _quantize_leaf(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis: ``(q, scale)`` with ``w ~ q *
    scale``, the scale keeping the reduced axes as size 1 (float32)."""
    wf = w.float()
    amax = torch.amax(wf.abs(), dim=tuple(range(w.ndim - 1)), keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_tree(params: Mapping[str, torch.Tensor], views: Mapping[str, str]
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Quantize every parameter whose flax view is at least 2-D; the others
    pass through with a unit float32 scale, so the two dicts share their
    keys (in ``params``' order)."""
    from eo_diffusion_torch.weights import torch_transforms

    qt, st = {}, {}
    for name, w in params.items():
        to_torch, to_flax = torch_transforms(views[name])
        wf = to_flax(w.detach())
        if wf.ndim >= 2:
            q, s = _quantize_leaf(wf)
            qt[name], st[name] = to_torch(q).contiguous(), to_torch(s).contiguous()
        else:
            qt[name] = w.detach()
            st[name] = torch.ones((), dtype=torch.float32, device=w.device)
    return qt, st


def dequantize_tree(qt: Mapping[str, torch.Tensor], st: Mapping[str, torch.Tensor],
                    dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The float parameters back: one multiply a quantized leaf (in float32,
    then ``dtype``); pass-through leaves are returned as they are."""
    return {name: ((q.float() * st[name]).to(dtype) if q.dtype == torch.int8 else q)
            for name, q in qt.items()}


def quantized_bytes(qt: Mapping[str, torch.Tensor]) -> int:
    """Bytes of the packed parameters (int8 leaves at one byte a value)."""
    return sum(t.numel() * t.element_size() for t in qt.values())
