"""ControlNet adapters in PyTorch (counterpart of ``eo_diffusion_tpu/models/controlnet.py``;
Zhang et al., arXiv:2302.05543).

A new conditioning stream (SAR, DEM, a cloudy co-registered view) steers a
trained, frozen UNet through:

* a trainable copy of the UNet's encoder (input blocks and middle block,
  built from the same :func:`build_unet_plan` and layers, so the attention
  and GroupNorm kernels serve it), started from the base weights by
  :func:`init_from_base`;
* a hint encoder ``hint_0`` (16) -> ``hint_1`` (32) -> zero-init
  ``hint_out``, added after the stem conv;
* zero-init 1 x 1 convs ``zero_{bi}`` on every input block's output and
  ``zero_middle`` on the middle block's. Their residuals go to
  ``UNet.forward(..., control=...)``, which adds them to the skips and the
  middle output; the base runs unmodified.

The encoder copy keeps the UNet's own module names (``time_embed``,
``label_emb``, ``input_blocks``, ``middle_block``), so copying the base is a
match of state-dict names. :func:`save_controlnet` / :func:`load_controlnet`
read and write the JAX package's files: ``controlnet.npz`` keyed by flax
``keystr`` paths (``['params']['input_0_0']['kernel']``, ...) and
``controlnet.json``, so an adapter trained by the JAX ``cli.finetune``
loads here, and the other way round.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eo_diffusion_torch.models.unet import UNet, UNetConfig, _make_layer, build_unet_plan
from eo_diffusion_torch.nn.primitives import Conv, Dense, ZeroConv, timestep_embedding

__all__ = ["ControlNet", "init_from_base", "controlled_apply_fn", "control_param_count",
           "save_controlnet", "load_controlnet"]


class ControlNet(nn.Module):
    """``forward(x, t, hint, y=None)`` -> ``(block_residuals, middle_residual)``:
    one residual a UNet input block (the skips' widths) and the middle
    block's, for ``UNet.forward(..., control=...)`` on the frozen base."""

    def __init__(self, config: UNetConfig, hint_channels: int):
        super().__init__()
        cfg = self.config = config
        assert cfg.context_dim == 0, "ControlNet adapters are wired for the self-attention UNet"
        self.hint_channels = hint_channels
        plan = build_unet_plan(cfg)
        ted, dt = cfg.time_embed_dim, cfg.dtype
        self.time_embed = nn.Sequential(Dense(cfg.model_channels, ted, dtype=dt), nn.SiLU(),
                                        Dense(ted, ted, dtype=dt))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.label_vocab, ted)
        first_ch = int(cfg.channel_mult[0] * cfg.model_channels)
        self.hint_0 = Conv(hint_channels, 16, 3, dtype=dt)
        self.hint_1 = Conv(16, 32, 3, dtype=dt)
        self.hint_out = ZeroConv(32, first_ch, 3, dtype=dt)
        mk = lambda block: nn.ModuleList([_make_layer(cfg, s) for s in block])
        self.input_blocks = nn.ModuleList([mk(b) for b in plan.input_blocks])
        self.middle_block = mk(plan.middle_block)
        self.zero_convs = []
        for bi, block in enumerate(plan.input_blocks):
            ch = block[-1].out_ch
            self.add_module(f"zero_{bi}", ZeroConv(ch, ch, 1, dtype=dt))  # the flax names
            self.zero_convs.append(getattr(self, f"zero_{bi}"))
        self.zero_middle = ZeroConv(plan.middle_block[-1].out_ch, plan.middle_block[-1].out_ch,
                                    1, dtype=dt)

    set_impl = UNet.set_impl

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, hint: torch.Tensor,
                y: Optional[torch.Tensor] = None
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        cfg = self.config
        assert x.shape[-1] == cfg.in_channels, (x.shape, cfg.in_channels)
        assert hint.shape[-1] == self.hint_channels, (hint.shape, self.hint_channels)
        emb = self.time_embed(timestep_embedding(timesteps, cfg.model_channels))
        if cfg.num_classes is not None:
            assert y is not None, "class-conditional base needs y"
            emb = emb + self.label_emb(y).to(emb.dtype)
        g = F.silu(self.hint_0(hint.to(cfg.dtype)))
        g = self.hint_out(F.silu(self.hint_1(g)))
        h = x.to(cfg.dtype)
        residuals = []
        for bi, block in enumerate(self.input_blocks):
            h = UNet._run(block, h, emb)
            if bi == 0:
                h = h + g  # the hint joins after the stem conv (paper eq. 5)
            residuals.append(self.zero_convs[bi](h))
        h = UNet._run(self.middle_block, h, emb)
        return tuple(residuals), self.zero_middle(h)


def _flax_modules(cnet: ControlNet) -> Dict[str, list]:
    """Flax top-level module name -> the state-dict names it holds."""
    from eo_diffusion_torch.weights import controlnet_layout

    out = {}
    for fpath, tname, _, _ in controlnet_layout(cnet.config, cnet.hint_channels):
        out.setdefault(fpath[0], []).append(tname)
    return out


def init_from_base(cnet: ControlNet, base: UNet) -> int:
    """Copy the base UNet's encoder weights into ``cnet`` (the trainable copy
    starts as the trained encoder), module by flax top-level module
    (``input_*``, ``middle_*``, ``time_embed_*``, ``label_emb``): a module is
    copied only when every one of its parameters exists in the base with the
    same shape (a base stem that took concat channels stays fresh). The hint
    encoder and the zero convs keep their init. Returns the number of
    parameters copied."""
    base_sd = base.state_dict()
    own = dict(cnet.named_parameters())
    copied = 0
    with torch.no_grad():
        for names in _flax_modules(cnet).values():
            if all(n in base_sd and base_sd[n].shape == own[n].shape for n in names):
                for n in names:
                    own[n].copy_(base_sd[n])
                copied += len(names)
    return copied


def controlled_apply_fn(model: UNet, cnet: ControlNet):
    """The denoiser ``fn(x, t, hint, y=None)``: the frozen base under the
    adapter's residuals. The hint rides the samplers' ``cond`` slot; the base
    sees no cond."""

    def fn(x, t, hint, y=None):
        return model(x, t, y=y, control=cnet(x, t, hint, y=y))

    return fn


def control_param_count(cnet: ControlNet) -> int:
    return sum(p.numel() for p in cnet.parameters())


def save_controlnet(outdir: str, cnet: ControlNet, meta: dict) -> None:
    """``controlnet.npz`` (flax ``keystr`` paths, the JAX package's layout) and
    ``controlnet.json`` under ``outdir``."""
    from eo_diffusion_torch.weights import controlnet_layout, keystr

    sd = {k: v.detach().float().cpu().numpy() for k, v in cnet.state_dict().items()}
    flat = {keystr(("params",) + fpath): inv(sd[tname])
            for fpath, tname, _, inv in controlnet_layout(cnet.config, cnet.hint_channels)}
    os.makedirs(outdir, exist_ok=True)
    np.savez(os.path.join(outdir, "controlnet.npz"), **flat)
    with open(os.path.join(outdir, "controlnet.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_controlnet(path: str, cnet: ControlNet) -> dict:
    """Fill ``cnet`` from a ``controlnet.npz`` (``path``: its directory or the
    file); every leaf of the layout must be there with its shape. Returns the
    metadata of ``controlnet.json`` beside it ({} if none)."""
    from eo_diffusion_torch.weights import controlnet_layout, keystr

    npz = path if path.endswith(".npz") else os.path.join(path, "controlnet.npz")
    data = np.load(npz)
    own = cnet.state_dict()
    sd = {}
    for fpath, tname, fwd, _ in controlnet_layout(cnet.config, cnet.hint_channels):
        k = keystr(("params",) + fpath)
        assert k in data.files, f"missing leaf in {npz}: {k}"
        arr = np.asarray(fwd(data[k]), np.float32)
        assert tuple(arr.shape) == tuple(own[tname].shape), (k, arr.shape, own[tname].shape)
        sd[tname] = torch.from_numpy(arr.copy())
    cnet.load_state_dict(sd, strict=True)
    meta_path = os.path.join(os.path.dirname(npz), "controlnet.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return meta
