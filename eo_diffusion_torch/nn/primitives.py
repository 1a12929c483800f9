"""NN primitives for the PyTorch UNet (counterpart of ``eo_diffusion_tpu/nn/primitives.py``).

Tensors are NHWC ``[N, H, W, C]`` at every public boundary, like the JAX
package. A conv permutes its input to NCHW, which for an NHWC-contiguous
tensor is a ``channels_last`` view (no copy), and permutes the result back.

Parameters are stored float32 in the reference's torch layouts (conv
``[O, I, kh, kw]``, linear ``[O, I]``, GroupNorm ``weight``/``bias``) and cast
to the layer's compute ``dtype`` at the call, where flax's ``dtype=`` puts the
cast.

* ``timestep_embedding`` -> reference ``unet_openai.py:81-99`` (f32, cos | sin)
* ``GroupNorm32``        -> reference ``unet_openai.py:11-13`` (f32 statistics),
  through the fused GroupNorm + FiLM + SiLU kernel on the card
* ``Zero*``              -> reference ``zero_module`` (``unet_openai.py:62-68``)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from eo_diffusion_torch.ops.conv_wgrad import conv3x3
from eo_diffusion_torch.ops.group_norm import fused_group_norm

__all__ = [
    "timestep_embedding",
    "GroupNorm32",
    "Conv",
    "ZeroConv",
    "Dense",
    "ZeroDense",
    "PointwiseConv1d",
    "DepthwiseConv",
    "avg_pool_2d",
    "nearest_upsample_2d",
]


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embeddings: ``[N]`` -> ``[N, dim]`` float32,
    ``cos | sin`` halves, zero-padded when ``dim`` is odd."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _num_groups(ch: int, num_groups: int = 32) -> int:
    # 32 groups whenever divisible (reference parity); otherwise the largest
    # divisor <= 32, as the JAX package does for narrow widths
    groups = min(num_groups, ch)
    while ch % groups:
        groups -= 1
    return groups


class GroupNorm32(nn.Module):
    """GroupNorm over a channels-last tensor ``[N, ..., C]`` with float32
    statistics (eps 1e-5) whatever the activation dtype; the result is cast
    back to the input dtype.

    ``forward(x, act="none", scale=None, shift=None)`` folds an activation
    (``"silu"``) and a per-sample FiLM scale-shift (``[N, C]`` each:
    ``gamma = weight * (1 + scale)``, ``beta = bias * (1 + scale) + shift``)
    into one :func:`~eo_diffusion_torch.ops.group_norm.fused_group_norm`
    call: the kernel on the card while ``impl`` is ``"auto"``, the plain
    version anywhere once it is ``"plain"`` (``UNet.set_impl``).
    """

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups = _num_groups(channels, num_groups)
        self.eps = eps
        self.impl = "auto"
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, act: str = "none", scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        gamma, beta = self.weight, self.bias
        if scale is not None:
            s = 1 + scale.float()
            gamma, beta = gamma * s, beta * s + shift.float()
        return fused_group_norm(x, gamma, beta, self.groups, self.eps, act, self.impl)


class Conv(nn.Conv2d):
    """2D conv on NHWC tensors with torch-style padding ``(k-1)//2``,
    computed in ``dtype``.

    A 3x3 stride-1 conv goes through
    :func:`~eo_diffusion_torch.ops.conv_wgrad.conv3x3`: on the card, while
    ``impl`` is ``"auto"``, its weight gradient is the hand-written kernel
    wherever ``wgrad_route`` gives the shape one; ``"plain"``
    (``UNet.set_impl(conv=)``) keeps cuDNN's autograd. Other convs always
    take cuDNN's."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=(kernel - 1) // 2)
        self.compute_dtype = dtype
        self.impl = "auto"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.kernel_size == (3, 3) and self.stride == (1, 1):
            return conv3x3(x, self.weight, self.bias, dt, self.impl)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt),
                     self.bias.to(dt), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ZeroConv(Conv):
    """Zero-initialized :class:`Conv` (reference ``zero_module``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, dtype=dtype)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class Dense(nn.Linear):
    """Linear layer over the last axis, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ZeroDense(Dense):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, dtype=dtype)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class PointwiseConv1d(nn.Conv1d):
    """A kernel-1 Conv1d (the reference attention's ``qkv``/``proj_out``)
    applied as a linear layer over the last axis of ``[B, T, C]``. The weight
    keeps the reference's ``[O, I, 1]`` shape so checkpoints load unrenamed."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 zero: bool = False):
        super().__init__(in_ch, out_ch, 1)
        self.compute_dtype = dtype
        if zero:
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight[:, :, 0].to(dt), self.bias.to(dt))


class DepthwiseConv(nn.Conv2d):
    """A depthwise ``k x k`` conv on NHWC tensors (flax ``nn.Conv`` with
    ``feature_group_count = C``; its ``[k, k, 1, C]`` kernel is this
    ``[C, 1, k, k]`` weight), padding ``(k-1)//2``, computed in ``dtype``
    with cuDNN's convolution."""

    def __init__(self, ch: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(ch, ch, kernel, stride=stride, padding=(kernel - 1) // 2, groups=ch)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), self.bias.to(dt),
                     self.stride, self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


def avg_pool_2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Average pooling, NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)


def nearest_upsample_2d(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample, NHWC, with the reference's 3x3 -> 7x7
    pad (``unet_openai.py:237-239``): a 3x3 input upsamples to 6x6 and is
    padded at the top/left to 7x7 so odd pyramids (28 px) round-trip."""
    h, w = x.shape[1], x.shape[2]
    out = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                        mode="nearest").permute(0, 2, 3, 1)
    if h == w == 3:
        out = F.pad(out, (0, 0, 1, 0, 1, 0))
    return out
