"""LoRA parameter-efficient fine-tuning (counterpart of
``eo_diffusion_tpu/train/lora.py``; Hu et al. 2021, arXiv:2106.09685).

Adapt a trained checkpoint to a new domain (another sensor, region or
season) by training only low-rank deltas on the kernel leaves: ``W_eff = W +
(alpha / r) * A @ B`` with ``A ~ N(0, 1 / r)`` and ``B = 0``, so a fresh
adapter is the identity.

The targets and the deltas live in the JAX package's flax view, so that an
adapter trained by either package loads in the other: every leaf named
``kernel`` whose flax array is 2-D or 4-D (Dense ``[in, out]``, the
attention's ``qkv`` / ``proj_out``, which are 3-D ``[out, in, 1]`` Conv1d
weights in torch, a conv's HWIO, a transposed conv's kernel, which torch
holds flipped in space), keyed by its ``keystr`` path
(``['params']['input_1_0']['in_conv']['kernel']``). The delta is built in
the ``[kh*kw*cin, cout]`` view, reshaped to the flax kernel and carried to
the torch parameter by its layout entry's torch twin
(``weights.torch_transforms``), on the device and differentiably.

For training, :func:`merged_parameters` gives the merged tensors for
``torch.func.functional_call`` (the base frozen, only A and B take
gradients); for sampling, :func:`lora_merge_` adds the deltas in place once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = ["lora_spec", "lora_init", "merged_parameters", "lora_merge_", "lora_param_count",
           "lora_targets"]

Adapters = Dict[str, Dict[str, torch.Tensor]]


def lora_targets(model: nn.Module, match: Optional[Sequence[str]] = None
                 ) -> Dict[str, Tuple[str, tuple, str]]:
    """``{keystr path: (torch name, flax kernel shape, transform name)}`` of
    every targeted leaf (JAX ``_is_target``): named ``kernel``, 2-D or 4-D in
    the flax view, and when ``match`` is given, a path containing one of its
    substrings."""
    from eo_diffusion_torch.weights import _TWIN, flax_shape, keystr, model_layout

    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out = {}
    for fpath, tname, _, inv in model_layout(model):
        if fpath[-1] != "kernel":
            continue
        fshape = flax_shape(shapes[tname], inv)
        if len(fshape) not in (2, 4):
            continue
        k = keystr(("params",) + tuple(fpath))
        if match is None or any(m in k for m in match):
            out[k] = (tname, fshape, _TWIN[inv])
    return out


def lora_spec(model: nn.Module, match: Optional[Sequence[str]] = None) -> Dict[str, tuple]:
    """``{keystr path: flax kernel shape}`` of every targeted leaf (JAX
    ``lora_spec``)."""
    return {k: v[1] for k, v in lora_targets(model, match).items()}


def _dims(shape) -> tuple:
    """(fan_in, fan_out) of the 2-D view the delta is built in."""
    if len(shape) == 2:
        return shape[0], shape[1]
    kh, kw, cin, cout = shape
    return kh * kw * cin, cout


def lora_init(model: nn.Module, rank: int = 8, match: Optional[Sequence[str]] = None,
              generator: Optional[torch.Generator] = None, device=None) -> Adapters:
    """The adapters ``{path: {"a": [d_in, r], "b": [r, d_out]}}`` in float32,
    in the order of ``sorted(spec)`` (JAX ``lora_init``): A drawn from
    ``generator`` (on the CPU) as N(0, 1) / sqrt(r), B zero, r capped at
    ``min(rank, d_in, d_out)``; ``nn.Parameter`` s on ``device`` (the
    model's by default)."""
    spec = lora_spec(model, match)
    assert spec, "no kernels matched the LoRA target spec"
    device = device if device is not None else next(model.parameters()).device
    lora = {}
    for k, shape in sorted(spec.items()):
        d_in, d_out = _dims(shape)
        r = min(rank, d_in, d_out)
        a = torch.randn(d_in, r, generator=generator) / r ** 0.5
        lora[k] = {"a": nn.Parameter(a.to(device)),
                   "b": nn.Parameter(torch.zeros(r, d_out, device=device))}
    return lora


def _delta(ab: Dict[str, torch.Tensor], fshape: tuple, view: str, alpha: float) -> torch.Tensor:
    """``(alpha / r) * A @ B`` reshaped to the flax kernel, in torch's layout."""
    from eo_diffusion_torch.weights import torch_transforms

    r = ab["a"].shape[1]
    delta = (ab["a"] @ ab["b"]).reshape(fshape) * (alpha / r)
    return torch_transforms(view)[0](delta)


def merged_parameters(model: nn.Module, lora: Adapters, alpha: float = 8.0,
                      targets=None) -> Dict[str, torch.Tensor]:
    """``{torch name: base + delta}`` for every adapted parameter, for
    ``torch.func.functional_call(model, merged, ...)``: differentiable in the
    adapters, the base parameters detached. ``targets``: a cached
    :func:`lora_targets` of the model."""
    targets = targets if targets is not None else lora_targets(model)
    params = dict(model.named_parameters())
    out = {}
    for k, ab in lora.items():
        tname, fshape, view = targets[k]
        base = params[tname].detach()
        out[tname] = base + _delta(ab, fshape, view, alpha).to(base.dtype)
    return out


@torch.no_grad()
def lora_merge_(model: nn.Module, lora: Adapters, alpha: float = 8.0) -> nn.Module:
    """Add every adapter's delta to its parameter in place (sampling merges
    once, at load; JAX ``lora_merge`` on the served weights). Every adapter
    must name a target of ``model`` with its shape."""
    targets = lora_targets(model)
    params = dict(model.named_parameters())
    for k, ab in lora.items():
        assert k in targets, f"the adapter's {k} is no LoRA target of this model"
        tname, fshape, view = targets[k]
        assert (ab["a"].shape[0], ab["b"].shape[1]) == _dims(fshape), (k, fshape)
        p = params[tname]
        ab = {n: v.to(p.device, torch.float32) for n, v in ab.items()}
        p.add_(_delta(ab, fshape, view, alpha).to(p.dtype))
    return model


def lora_param_count(lora: Adapters) -> int:
    return sum(v.numel() for ab in lora.values() for v in ab.values())
