"""Tiny ShuffleNet-v2-style UNet in PyTorch (counterpart of
``eo_diffusion_tpu/models/unet_tiny.py``; reference ``backbones/unet_mnist.py``).

ShuffleNet bottlenecks with a channel split and a channel shuffle in JAX's
``(groups, C/groups)`` order, depthwise convs padded ``(k-1)//2``, a learned
timestep table and bilinear decoder upsampling (``F.interpolate(...,
"bilinear")`` without corner alignment, which is ``jax.image.resize``'s
half-pixel rule when upsampling). Every norm is a :class:`GroupNorm32`, so
on the card the GroupNorm kernel (K5) runs each one, with the SiLU after a
pointwise conv folded in. Submodules carry the flax names (``init_conv``,
``enc{i}_res{j}``, ``branch1_dw.dwconv``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eo_diffusion_torch.models.unet import UNet
from eo_diffusion_torch.nn.primitives import Conv, Dense, DepthwiseConv, GroupNorm32

__all__ = ["TinyUNetConfig", "TinyUNet"]


@dataclasses.dataclass(frozen=True)
class TinyUNetConfig:
    timesteps: int = 1000
    time_embedding_dim: int = 128
    in_channels: int = 1
    out_channels: int = 1
    base_dim: int = 32
    dim_mults: Tuple[int, ...] = (2, 4)
    dtype: torch.dtype = torch.float32

    def channels(self) -> List[Tuple[int, int]]:
        dims = [self.base_dim] + [self.base_dim * m for m in self.dim_mults]
        return list(zip(dims[:-1], dims[1:]))


def _channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4).reshape(n, h, w, c)


class ConvNormSiLU(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 1, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel, stride=stride, dtype=dtype)
        self.norm = GroupNorm32(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x), act="silu")


class DepthwiseConvNorm(nn.Module):
    def __init__(self, ch: int, kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = DepthwiseConv(ch, kernel, stride=stride, dtype=dtype)
        self.norm = GroupNorm32(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.dwconv(x))


class ResidualBottleneck(nn.Module):
    """ShuffleNet-v2 basic unit (``unet_mnist.py:28-49``): split, two
    branches, concat, shuffle."""

    def __init__(self, in_ch: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        half, out = in_ch // 2, out_channels // 2
        self.branch1_dw = DepthwiseConvNorm(half, dtype=dtype)
        self.branch1_pw = ConvNormSiLU(half, out, dtype=dtype)
        self.branch2_pw1 = ConvNormSiLU(in_ch - half, in_ch - half, dtype=dtype)
        self.branch2_dw = DepthwiseConvNorm(in_ch - half, dtype=dtype)
        self.branch2_pw2 = ConvNormSiLU(in_ch - half, out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=-1)
        b1 = self.branch1_pw(self.branch1_dw(x1))
        b2 = self.branch2_pw2(self.branch2_dw(self.branch2_pw1(x2)))
        return _channel_shuffle(torch.cat([b1, b2], dim=-1))


class ResidualDownsample(nn.Module):
    """ShuffleNet-v2 downsample unit (``unet_mnist.py:51-70``)."""

    def __init__(self, in_ch: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        out = out_channels // 2
        self.branch1_dw = DepthwiseConvNorm(in_ch, stride=2, dtype=dtype)
        self.branch1_pw = ConvNormSiLU(in_ch, out, dtype=dtype)
        self.branch2_pw1 = ConvNormSiLU(in_ch, out, dtype=dtype)
        self.branch2_dw = DepthwiseConvNorm(out, stride=2, dtype=dtype)
        self.branch2_pw2 = ConvNormSiLU(out, out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1_pw(self.branch1_dw(x))
        b2 = self.branch2_pw2(self.branch2_dw(self.branch2_pw1(x)))
        return _channel_shuffle(torch.cat([b1, b2], dim=-1))


class TimeMLP(nn.Module):
    """Add the projected time embedding, then SiLU (``unet_mnist.py:72-86``)."""

    def __init__(self, emb_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(emb_dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, out_dim, dtype=dtype)
        self.fc1.int8 = self.fc2.int8 = False  # flax nn.Dense in JAX: no W8A8 route

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.fc2(F.silu(self.fc1(t_emb)))
        return F.silu(x + h[:, None, None, :].to(x.dtype))


class TinyUNet(nn.Module):
    """``forward(x [N, H, W, C], t [N], cond=None, y=None)`` -> ``[N, H, W,
    out_channels]`` (reference ``Unet``, ``unet_mnist.py:125-170``), float32
    whatever the compute dtype."""

    set_impl = UNet.set_impl

    def __init__(self, config: TinyUNetConfig, in_channels: Optional[int] = None):
        """``in_channels``: x's channels and a concat cond's (default
        ``config.in_channels``)."""
        super().__init__()
        cfg = self.config = config
        dt, ted = cfg.dtype, cfg.time_embedding_dim
        channels = cfg.channels()
        self.init_conv = ConvNormSiLU(in_channels or cfg.in_channels, cfg.base_dim, 3, dtype=dt)
        self.time_embedding = nn.Embedding(cfg.timesteps, ted)
        for i, (cin, cout) in enumerate(channels):
            for j in range(3):
                self.add_module(f"enc{i}_res{j}", ResidualBottleneck(cin, cin, dtype=dt))
            self.add_module(f"enc{i}_res3", ResidualBottleneck(cin, cout // 2, dtype=dt))
            self.add_module(f"enc{i}_time", TimeMLP(ted, cout, cout // 2, dtype=dt))
            self.add_module(f"enc{i}_down", ResidualDownsample(cout // 2, cout, dtype=dt))
        mid_c = channels[-1][1]
        for j in range(2):
            self.add_module(f"mid_res{j}", ResidualBottleneck(mid_c, mid_c, dtype=dt))
        self.mid_res2 = ResidualBottleneck(mid_c, mid_c // 2, dtype=dt)
        x_ch = mid_c // 2
        for i, (cin, cout) in enumerate(reversed(channels)):
            cc = x_ch + cout // 2
            for j in range(3):
                self.add_module(f"dec{i}_res{j}", ResidualBottleneck(cc, cc, dtype=dt))
            self.add_module(f"dec{i}_res3", ResidualBottleneck(cc, cc // 2, dtype=dt))
            self.add_module(f"dec{i}_time", TimeMLP(ted, cc, cc // 2, dtype=dt))
            self.add_module(f"dec{i}_res4", ResidualBottleneck(cc // 2, cin // 2, dtype=dt))
            x_ch = cin // 2
        self.final_conv = Conv(x_ch, cfg.out_channels, 1, dtype=dt)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        n_lvl = len(cfg.dim_mults)
        if cond is not None:
            x = torch.cat([x, cond.to(x.dtype)], dim=-1)
        x = self.init_conv(x.to(cfg.dtype))
        t_emb = self.time_embedding(t.long())
        shortcuts = []
        for i in range(n_lvl):
            for j in range(4):
                x = getattr(self, f"enc{i}_res{j}")(x)
            shortcuts.append(x)
            x = getattr(self, f"enc{i}_time")(x, t_emb)
            x = getattr(self, f"enc{i}_down")(x)
        for j in range(3):
            x = getattr(self, f"mid_res{j}")(x)
        for i in range(n_lvl):
            n, h, w, c = x.shape
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * h, 2 * w), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
            x = torch.cat([x, shortcuts.pop().to(x.dtype)], dim=-1)
            for j in range(4):
                x = getattr(self, f"dec{i}_res{j}")(x)
            x = getattr(self, f"dec{i}_time")(x, t_emb)
            x = getattr(self, f"dec{i}_res4")(x)
        return self.final_conv(x).float()
