"""SPADE / SDM semantic-diffusion UNet in PyTorch (counterpart of
``eo_diffusion_tpu/models/unet_spade.py``).

Every ResBlock's norms are spatially modulated by a segmentation map
(``SPADEGroupNorm``, reference ``backbones/unet.py:156-182``): parameter-free
GroupNorm statistics, then ``xhat * (1 + gamma(seg)) + beta(seg)`` with gamma
and beta from a small conv net on the segmap resized to the feature grid.
The segmap rides the ``cond`` argument, so the diffusion processes and
samplers are the UNet's.

* The statistics are computed on a float32 cast of x, as in JAX, through the
  GroupNorm kernel (K5) in float32 with unit gamma, zero beta and no
  activation: the same numbers, and the kernel stays on the path. The
  modulation is float32, cast back to x's dtype.
* The segmap is resized with ``mode="nearest-exact"``, the half-pixel rule
  of ``jax.image.resize(..., "nearest")`` (torch's ``"nearest"`` picks other
  pixels: 8 -> 4 gives ``[0, 2, 4, 6]``, JAX ``[1, 3, 5, 7]``).
* The attention blocks are the UNet's :class:`AttentionBlock` in the legacy
  head order, so K1 (and K4 in training) serve them; the output norm is a
  :class:`GroupNorm32` with the SiLU folded in.

Submodules carry the flax names (``stem``, ``enc_{l}_{j}``,
``enc_attn_{l}_{j}``, ``enc_down_{l}``, ``mid_0``, ``mid_attn``, ``mid_1``,
``dec_{l}_{j}``, ``dec_attn_{l}_{j}``, ``dec_up_{l}``, ``out_norm``,
``out_conv``; inside a block ``in_norm.mlp_shared`` ...), so
:func:`eo_diffusion_torch.weights.flax_state_dict` maps a flax tree by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eo_diffusion_torch.models.unet import AttentionBlock, UNet
from eo_diffusion_torch.nn.primitives import (Conv, Dense, GroupNorm32, ZeroConv, _num_groups,
                                              avg_pool_2d, nearest_upsample_2d,
                                              timestep_embedding)
from eo_diffusion_torch.ops.group_norm import fused_group_norm

__all__ = ["SpadeUNetConfig", "SpadeUNet", "SPADEGroupNorm", "resize_nearest"]


@dataclasses.dataclass(frozen=True)
class SpadeUNetConfig:
    image_size: int
    in_channels: int
    model_channels: int
    out_channels: int
    label_channels: int  # segmap channels (one-hot classes or soft masks)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = ()
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_heads: int = 1
    time_emb_factor: int = 4
    spade_hidden: int = 128
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "attention_resolutions", tuple(self.attention_resolutions))
        object.__setattr__(self, "channel_mult", tuple(self.channel_mult))


def resize_nearest(seg: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(seg, (n, h, w, c), "nearest")`` on NHWC: the source
    pixel ``floor((i + 0.5) * in / out)``."""
    if seg.shape[1:3] == (h, w):
        return seg
    return F.interpolate(seg.permute(0, 3, 1, 2), size=(h, w),
                         mode="nearest-exact").permute(0, 2, 3, 1)


class SPADEGroupNorm(nn.Module):
    """Segmap-modulated GroupNorm: float32 statistics (K5 with unit gamma,
    zero beta) in ``min(32, c)`` groups, decremented until they divide c,
    then ``xhat * (1 + gamma(seg)) + beta(seg)``, gamma and beta from
    ``mlp_shared`` -> ReLU -> ``mlp_gamma`` / ``mlp_beta`` (3 x 3 convs in
    the compute dtype). ``impl`` as :class:`GroupNorm32`'s."""

    def __init__(self, channels: int, label_channels: int, hidden: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups = _num_groups(channels)
        self.compute_dtype = dtype
        self.impl = "auto"
        self.mlp_shared = Conv(label_channels, hidden, 3, dtype=dtype)
        self.mlp_gamma = Conv(hidden, channels, 3, dtype=dtype)
        self.mlp_beta = Conv(hidden, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        ones = torch.ones(c, dtype=torch.float32, device=x.device)
        xhat = fused_group_norm(x.float(), ones, torch.zeros_like(ones), self.groups, 1e-5,
                                "none", self.impl)
        seg = resize_nearest(seg, h, w).to(self.compute_dtype)
        actv = F.relu(self.mlp_shared(seg))
        gamma, beta = self.mlp_gamma(actv).float(), self.mlp_beta(actv).float()
        return (xhat * (1.0 + gamma) + beta).to(x.dtype)


class SDMResBlock(nn.Module):
    """SPADE-normalised residual block (reference ``SDMResBlock``,
    unet.py:301-417): SPADE-GN -> SiLU -> (resample) -> conv, + the timestep
    embedding, SPADE-GN -> SiLU -> zero conv, a 1 x 1 skip on a width
    change."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, label_channels: int,
                 spade_hidden: int = 128, up: bool = False, down: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up, self.down = up, down
        self.in_norm = SPADEGroupNorm(in_ch, label_channels, spade_hidden, dtype)
        self.in_conv = Conv(in_ch, out_ch, 3, dtype=dtype)
        self.emb_proj = Dense(emb_ch, out_ch, dtype=dtype)
        self.out_norm = SPADEGroupNorm(out_ch, label_channels, spade_hidden, dtype)
        self.out_conv = ZeroConv(out_ch, out_ch, 3, dtype=dtype)
        self.skip_conv = Conv(in_ch, out_ch, 1, dtype=dtype) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.in_norm(x, seg))
        if self.up:
            h, x = nearest_upsample_2d(h), nearest_upsample_2d(x)
        elif self.down:
            h, x = avg_pool_2d(h), avg_pool_2d(x)
        h = self.in_conv(h)
        h = h + self.emb_proj(F.silu(emb))[:, None, None, :].to(h.dtype)
        h = self.out_conv(F.silu(self.out_norm(h, seg)))
        return (x if self.skip_conv is None else self.skip_conv(x)) + h


class SpadeUNet(nn.Module):
    """``forward(x, t, cond=segmap, y=None)`` -> the eps prediction
    ``[N, H, W, out_channels]`` in x's dtype; the segmap is ``[N, H', W',
    label_channels]`` at any size."""

    def __init__(self, config: SpadeUNetConfig):
        super().__init__()
        cfg = self.config = config
        dt, mc, lc, sh = cfg.dtype, cfg.model_channels, cfg.label_channels, cfg.spade_hidden
        ted = mc * cfg.time_emb_factor
        self.time_embed_0 = Dense(mc, ted, dtype=dt)
        self.time_embed_2 = Dense(ted, ted, dtype=dt)
        self.stem = Conv(cfg.in_channels, mc, 3, dtype=dt)
        res = lambda cin, cout, **kw: SDMResBlock(cin, cout, ted, lc, sh, dtype=dt, **kw)
        attn = lambda c: AttentionBlock(c, cfg.num_heads, dtype=dt)
        self.layers = []  # (kind, name) in call order; "skip" pops a skip
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for j in range(cfg.num_res_blocks):
                self._add("res", f"enc_{level}_{j}", res(ch, mult * mc))
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    self._add("attn", f"enc_attn_{level}_{j}", attn(ch))
                self.layers.append(("push", None))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self._add("res", f"enc_down_{level}", res(ch, ch, down=True))
                self.layers.append(("push", None))
                chans.append(ch)
                ds *= 2
        self._add("res", "mid_0", res(ch, ch))
        if cfg.attention_resolutions:
            self._add("attn", "mid_attn", attn(ch))
        self._add("res", "mid_1", res(ch, ch))
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for j in range(cfg.num_res_blocks + 1):
                self.layers.append(("pop", None))
                self._add("res", f"dec_{level}_{j}", res(ch + chans.pop(), mult * mc))
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    self._add("attn", f"dec_attn_{level}_{j}", attn(ch))
            if level:
                self._add("res", f"dec_up_{level}", res(ch, ch, up=True))
                ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = ZeroConv(ch, cfg.out_channels, 3, dtype=dt)

    def _add(self, kind: str, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.layers.append((kind, name))

    def set_impl(self, attn: Optional[str] = None, norm: Optional[str] = None,
                 conv: Optional[str] = None) -> "SpadeUNet":
        """``UNet.set_impl``, the SPADE norms' statistics under ``norm``."""
        UNet.set_impl(self, attn=attn, norm=norm, conv=conv)
        for m in self.modules():
            if norm is not None and isinstance(m, SPADEGroupNorm):
                m.impl = norm
        return self

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        assert cond is not None, "SpadeUNet requires a segmap via cond"
        seg = cond
        emb = self.time_embed_0(timestep_embedding(timesteps, cfg.model_channels))
        emb = self.time_embed_2(F.silu(emb))
        h = self.stem(x.to(cfg.dtype))
        hs = [h]
        for kind, name in self.layers:
            if kind == "push":
                hs.append(h)
            elif kind == "pop":
                h = torch.cat([h, hs.pop().to(h.dtype)], dim=-1)
            elif kind == "res":
                h = getattr(self, name)(h, emb, seg)
            else:
                h = getattr(self, name)(h)
        h = self.out_conv(self.out_norm(h, act="silu"))
        return h.to(x.dtype)
