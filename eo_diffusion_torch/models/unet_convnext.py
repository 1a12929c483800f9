"""ConvNeXt-block UNet with linear attention in PyTorch (counterpart of
``eo_diffusion_tpu/models/unet_convnext.py``; reference
``backbones/unet_convnext.py``, lucidrains lineage).

Depthwise 7 x 7 ConvNeXt blocks (``unet_convnext.py:73-104``), linear
attention with a softmax over the keys (:106-126), a sinusoidal time MLP
and the ``residual`` / ``output_mean_scale`` output modes (:223-229). NHWC;
the per-pixel channel LayerNorm and the key softmax in float32; GELU is
flax's default, the tanh form. It has no GroupNorm and no dot-product
attention, so no kernel of the port serves it beyond the 3 x 3 convs'
weight gradient (where ``wgrad_route`` takes the shape). Submodules carry
the flax names (``down{i}_block1``, ``mid_attn``, ``up{i}_upsample``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eo_diffusion_torch.nn.primitives import Conv, Dense, DepthwiseConv, timestep_embedding

__all__ = ["ConvNextUNetConfig", "ConvNextUNet"]


@dataclasses.dataclass(frozen=True)
class ConvNextUNetConfig:
    dim: int = 64
    out_dim: Optional[int] = None
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    channels: int = 3
    with_time_emb: bool = True
    output_mean_scale: bool = False
    residual: bool = False
    dtype: torch.dtype = torch.float32


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of each pixel (``unet_convnext.py:50-60``):
    float32 statistics, eps 1e-5, scale ``g`` and shift ``b``."""

    def __init__(self, ch: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(ch))
        self.b = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=-1, keepdim=True, unbiased=False)
        return ((xf - mean) * torch.rsqrt(var + 1e-5) * self.g + self.b).to(x.dtype)


class ConvNextBlock(nn.Module):
    """Depthwise 7 x 7 -> (+ the time projection) -> LayerNorm -> conv, GELU,
    conv, residual (``unet_convnext.py:73-104``); ``time_dim=0`` builds no
    ``time_proj``."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int = 0, mult: int = 2,
                 norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ds_conv = DepthwiseConv(dim_in, 7, dtype=dtype)
        self.time_proj = Dense(time_dim, dim_in, dtype=dtype) if time_dim else None
        if self.time_proj is not None:
            self.time_proj.int8 = False  # flax nn.Dense in JAX: no W8A8 route
        self.norm = ChannelLayerNorm(dim_in) if norm else None
        self.net_conv1 = Conv(dim_in, dim_out * mult, 3, dtype=dtype)
        self.net_conv2 = Conv(dim_out * mult, dim_out, 3, dtype=dtype)
        self.res_conv = Conv(dim_in, dim_out, 1, dtype=dtype) if dim_in != dim_out else None

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.ds_conv(x)
        if self.time_proj is not None and t_emb is not None:
            h = h + self.time_proj(F.gelu(t_emb, approximate="tanh"))[:, None, None, :].to(h.dtype)
        if self.norm is not None:
            h = self.norm(h)
        h = self.net_conv2(F.gelu(self.net_conv1(h), approximate="tanh"))
        return h + (x if self.res_conv is None else self.res_conv(x))


class LinearAttention(nn.Module):
    """Linear attention (``unet_convnext.py:106-126``): q scaled by
    ``dim_head**-0.5``, a float32 softmax of k over the tokens, the ``[D, E]``
    context per head, then q against it."""

    def __init__(self, ch: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hid = heads * dim_head
        self.to_qkv = Conv(ch, 3 * hid, 1, dtype=dtype)
        self.to_qkv.bias = None  # flax use_bias=False
        self.to_out = Conv(hid, ch, 1, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, hh, ww, _ = x.shape
        dt = self.compute_dtype
        qkv = F.linear(x.to(dt), self.to_qkv.weight[:, :, 0, 0].to(dt))
        qkv = qkv.reshape(n, hh * ww, 3, self.heads, self.dim_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [N, T, H, D]
        q = q * (self.dim_head ** -0.5)
        k = torch.softmax(k.float(), dim=1).to(v.dtype)
        context = torch.einsum("bthd,bthe->bhde", k, v)
        out = torch.einsum("bhde,bthd->bthe", context, q)
        return self.to_out(out.reshape(n, hh, ww, -1))


class ConvNextUNet(nn.Module):
    """``forward(x, t=None, cond=None, y=None)``: downs, middle and ups of
    (block, block, linear attention, resample) (``unet_convnext.py:130-230``);
    returns float32 ``[N, H, W, out_dim or channels]``."""

    def __init__(self, config: ConvNextUNetConfig, in_channels: Optional[int] = None):
        """``in_channels``: the channels entering the first block (x and a
        concat cond; default ``config.channels``)."""
        super().__init__()
        cfg = self.config = config
        dt = cfg.dtype
        tdim = cfg.dim if cfg.with_time_emb else 0
        if cfg.with_time_emb:
            self.time_fc1 = Dense(cfg.dim, cfg.dim * 4, dtype=dt)
            self.time_fc2 = Dense(cfg.dim * 4, cfg.dim, dtype=dt)
            self.time_fc1.int8 = self.time_fc2.int8 = False  # flax nn.Dense in JAX
        dims = [in_channels or cfg.channels] + [cfg.dim * m for m in cfg.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.n_res = len(in_out)
        for i, (din, dout) in enumerate(in_out):
            self.add_module(f"down{i}_block1", ConvNextBlock(din, dout, tdim, norm=i != 0,
                                                             dtype=dt))
            self.add_module(f"down{i}_block2", ConvNextBlock(dout, dout, tdim, dtype=dt))
            self.add_module(f"down{i}_attn_norm", ChannelLayerNorm(dout))
            self.add_module(f"down{i}_attn", LinearAttention(dout, dtype=dt))
            if i < self.n_res - 1:
                self.add_module(f"down{i}_downsample", Conv(dout, dout, 4, stride=2, dtype=dt))
        mid = dims[-1]
        self.mid_block1 = ConvNextBlock(mid, mid, tdim, dtype=dt)
        self.mid_attn_norm = ChannelLayerNorm(mid)
        self.mid_attn = LinearAttention(mid, dtype=dt)
        self.mid_block2 = ConvNextBlock(mid, mid, tdim, dtype=dt)
        for i, (din, dout) in enumerate(reversed(in_out[1:])):
            self.add_module(f"up{i}_block1", ConvNextBlock(2 * dout, din, tdim, dtype=dt))
            self.add_module(f"up{i}_block2", ConvNextBlock(din, din, tdim, dtype=dt))
            self.add_module(f"up{i}_attn_norm", ChannelLayerNorm(din))
            self.add_module(f"up{i}_attn", LinearAttention(din, dtype=dt))
            # weight [in, out, 4, 4]: flax's [4, 4, in, out] kernel flipped in space
            self.add_module(f"up{i}_upsample", nn.ConvTranspose2d(din, din, 4, 2, 1))
        self.final_block = ConvNextBlock(dims[1], cfg.dim, 0, dtype=dt)
        self.final_conv = Conv(cfg.dim, cfg.out_dim or cfg.channels, 1, dtype=dt)

    def _attend(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return x + getattr(self, f"{prefix}_attn")(getattr(self, f"{prefix}_attn_norm")(x))

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        # the residual and mean references are the raw input, before the concat
        orig_x = x
        original_mean = x.mean(dim=(1, 2, 3), keepdim=True)
        if cond is not None:
            x = torch.cat([x, cond.to(x.dtype)], dim=-1)
        x = x.to(dt)
        t_emb = None
        if cfg.with_time_emb and t is not None:
            te = self.time_fc1(timestep_embedding(t, cfg.dim))
            t_emb = self.time_fc2(F.gelu(te, approximate="tanh"))
        hs = []
        for i in range(self.n_res):
            x = getattr(self, f"down{i}_block1")(x, t_emb)
            x = getattr(self, f"down{i}_block2")(x, t_emb)
            x = self._attend(f"down{i}", x)
            hs.append(x)
            if i < self.n_res - 1:
                x = getattr(self, f"down{i}_downsample")(x)
        x = self.mid_block1(x, t_emb)
        x = self._attend("mid", x)
        x = self.mid_block2(x, t_emb)
        # the deepest skip first; the stem-level skip stays unused, as in the reference
        for i in range(self.n_res - 1):
            x = torch.cat([x, hs.pop().to(x.dtype)], dim=-1)
            x = getattr(self, f"up{i}_block1")(x, t_emb)
            x = getattr(self, f"up{i}_block2")(x, t_emb)
            x = self._attend(f"up{i}", x)
            up = getattr(self, f"up{i}_upsample")
            x = F.conv_transpose2d(x.permute(0, 3, 1, 2), up.weight.to(dt), up.bias.to(dt),
                                   2, 1).permute(0, 2, 3, 1)
        x = self.final_block(x)
        out = self.final_conv(x).float()
        if cfg.residual:
            return out + orig_x
        if cfg.output_mean_scale:
            out = out - original_mean + out.mean(dim=(1, 2, 3), keepdim=True)
        return out
