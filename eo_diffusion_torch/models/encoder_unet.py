"""Encoder-half UNet classifier and the super-resolution UNet in PyTorch
(counterpart of ``eo_diffusion_tpu/models/encoder_unet.py``).

* :class:`EncoderUNet`: the UNet's encoder and middle blocks followed by an
  attention pool, giving class logits of a noisy image, ``f(x_t, t)``
  (reference ``EncoderUNetModel``, backbones/unet.py:845+). It is built from
  the port's own :class:`~eo_diffusion_torch.models.unet.ResBlock`,
  :class:`~eo_diffusion_torch.models.unet.AttentionBlock` and
  :class:`~eo_diffusion_torch.models.unet.Downsample`, so its self-attention
  runs the attention kernels and its norms the GroupNorm kernel on the card.
  Used for classifier training (``cli/train_classifier.py``) and
  classifier-guided sampling (``diffusion/classifier_guidance.py``).
* :class:`AttentionPool2d`: CLIP-style attention pooling (reference
  unet_openai.py:151-180). The JAX package computes it with plain einsums,
  so it is plain PyTorch here too.
* :class:`SuperResUNet`: the low-res image, nearest-upsampled to the target
  size, channel-concatenated to x (reference ``SuperResModel``,
  unet.py:828-842).

Submodules carry the JAX module names (``stem``, ``enc_{l}_{j}``,
``enc_attn_{l}_{j}``, ``down_{l}``, ``mid_0``, ``mid_1``, ``out_norm``,
``pool``, ``head``, ``time_embed_0`` / ``time_embed_2``), so
:func:`eo_diffusion_torch.weights.encoder_unet_state_dict_from_jax_params`
maps a flax tree by name. Tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eo_diffusion_torch.models.unet import (AttentionBlock, Downsample, ResBlock, UNet,
                                            UNetConfig)
from eo_diffusion_torch.nn.primitives import Conv, Dense, GroupNorm32, timestep_embedding

__all__ = ["EncoderUNetConfig", "EncoderUNet", "SuperResUNet", "AttentionPool2d"]


class AttentionPool2d(nn.Module):
    """Prepend the mean token, add a learned positional embedding, run one
    multi-head attention layer and return the mean token's output ``[N, out]``.
    q and k are each scaled by ``1 / sqrt(sqrt(ch))``; the softmax is float32."""

    def __init__(self, tokens: int, channels: int, num_heads: int,
                 out_features: Optional[int] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.randn(tokens + 1, channels) / channels**0.5)
        self.qkv_proj = Dense(channels, 3 * channels, dtype=dtype)
        self.c_proj = Dense(channels, out_features or channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        xt = x.reshape(n, h * w, c)
        xt = torch.cat([xt.mean(dim=1, keepdim=True), xt], dim=1)  # [N, T+1, C]
        xt = xt + self.positional_embedding[None].to(xt.dtype)
        heads = self.num_heads
        ch = c // heads
        qkv = self.qkv_proj(xt).reshape(n, h * w + 1, 3, heads, ch)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [N, H, T+1, ch]
        scale = (1.0 / torch.sqrt(torch.sqrt(torch.tensor(float(ch))))).to(q.dtype)
        wgt = torch.matmul(q * scale, (k * scale).transpose(-1, -2))
        wgt = torch.softmax(wgt.float(), dim=-1).to(v.dtype)
        a = torch.matmul(wgt, v).transpose(1, 2).reshape(n, h * w + 1, c)
        return self.c_proj(a)[:, 0]


@dataclasses.dataclass(frozen=True)
class EncoderUNetConfig:
    """The JAX ``EncoderUNetConfig``'s fields, in its order."""

    image_size: int
    in_channels: int
    model_channels: int
    num_classes: int
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = ()
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_heads: int = 4
    time_emb_factor: int = 4
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "attention_resolutions", tuple(self.attention_resolutions))
        object.__setattr__(self, "channel_mult", tuple(self.channel_mult))


class EncoderUNet(nn.Module):
    """Timestep-conditioned image classifier: ``forward(x [N,H,W,C], t [N])``
    -> float32 logits ``[N, num_classes]``. :meth:`set_impl` puts its
    attention and norms on their plain versions, as ``UNet.set_impl`` does."""

    set_impl = UNet.set_impl

    def __init__(self, config: EncoderUNetConfig):
        super().__init__()
        cfg = self.config = config
        dt, mc = cfg.dtype, cfg.model_channels
        ted = mc * cfg.time_emb_factor
        self.time_embed_0 = Dense(mc, ted, dtype=dt)
        self.time_embed_2 = Dense(ted, ted, dtype=dt)
        self.stem = Conv(cfg.in_channels, mc, 3, dtype=dt)
        self.layers = []  # (kind, name) in call order
        ch, ds, size = mc, 1, cfg.image_size
        for level, mult in enumerate(cfg.channel_mult):
            for j in range(cfg.num_res_blocks):
                self._add("res", f"enc_{level}_{j}", ResBlock(ch, mult * mc, ted, dtype=dt))
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    self._add("attn", f"enc_attn_{level}_{j}",
                              AttentionBlock(ch, cfg.num_heads, dtype=dt))
            if level != len(cfg.channel_mult) - 1:
                self._add("down", f"down_{level}", Downsample(ch, ch, dtype=dt))
                ds, size = ds * 2, -(-size // 2)
        self._add("res", "mid_0", ResBlock(ch, ch, ted, dtype=dt))
        self._add("res", "mid_1", ResBlock(ch, ch, ted, dtype=dt))
        self.out_norm = GroupNorm32(ch)
        self.pool = AttentionPool2d(size * size, ch, cfg.num_heads, dtype=dt)
        self.head = Dense(ch, cfg.num_classes, dtype=dt)

    def _add(self, kind: str, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.layers.append((kind, name))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        emb = self.time_embed_0(timestep_embedding(timesteps, cfg.model_channels))
        emb = self.time_embed_2(F.silu(emb))
        h = self.stem(x.to(cfg.dtype))
        for kind, name in self.layers:
            layer = getattr(self, name)
            h = layer(h, emb) if kind == "res" else layer(h)
        h = self.out_norm(h, act="silu")
        return self.head(self.pool(h)).float()


class SuperResUNet(nn.Module):
    """Low-res-conditioned UNet: ``forward(x, t, low_res, y=None)`` resizes
    ``low_res`` to x's size (nearest) and concatenates it as the cond; the
    inner UNet's ``in_channels`` must budget the extra channels."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.unet = UNet(config)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                low_res: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        assert low_res is not None, "SuperResUNet requires low_res"
        up = F.interpolate(low_res.permute(0, 3, 1, 2), size=tuple(x.shape[1:3]),
                           mode="nearest").permute(0, 2, 3, 1)
        return self.unet(x, timesteps, cond=up.to(x.dtype), y=y)
