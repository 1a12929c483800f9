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
* ``int8_dense_compute`` -> the JAX package's W8A8 route (``nn/primitives.py:139-208``):
  inside it, large ``Dense`` products (and the UNet attention's ``qkv``
  projection, a ``Dense`` in the JAX package) run as int8 x int8 -> int32
  products with a per-output-channel weight scale and a dynamic per-tensor
  activation scale
"""

from __future__ import annotations

import contextlib
import contextvars
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
    "int8_dense_compute",
    "int8_linear",
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


# W8A8 int8 compute (JAX nn/primitives.py:139-208). JAX routes while jit
# traces, so a compiled program's route is fixed; here the route is read at
# every call from a context variable, which belongs to the thread (or task)
# that entered the context: a serving worker under int8_dense_compute() does
# not route another thread's model calls. Products below the thresholds
# (rows, or either width) stay the plain product in the layer's dtype.
_INT8_DENSE = contextvars.ContextVar("int8_dense_compute", default=False)
_INT8_MIN_ROWS = 1024
_INT8_MIN_DIM = 256


@contextlib.contextmanager
def int8_dense_compute():
    """Route the large ``Dense`` products made inside, in this thread,
    through :func:`int8_linear`'s int8 path (``cli.inference --int8_compute``,
    ``ServingConfig.int8_compute``). Any float checkpoint serves under it:
    the weights are quantized at the call."""
    token = _INT8_DENSE.set(True)
    try:
        yield
    finally:
        _INT8_DENSE.reset(token)


def _int_mm(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """``qx [M, K] @ qw[N, K]^T`` of int8 values, exact, as int32. On the
    card ``torch._int_mm`` (M > 16, which the row threshold gives; K and N
    multiples of 8: zero columns are padded in, which changes no sum); on the
    CPU an int32 product of the same integers."""
    if not qx.is_cuda:
        return qx.to(torch.int32) @ qw.to(torch.int32).t()
    n, k = qw.shape
    pk, pn = -k % 8, -n % 8
    if pk:
        qx = F.pad(qx, (0, pk))
    if pk or pn:
        qw = F.pad(qw, (0, pk, 0, pn))
    return torch._int_mm(qx.contiguous(), qw.contiguous().t())[:, :n]


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's ``_Int8Dense`` on a torch ``[out, in]`` weight:
    below ``_INT8_MIN_ROWS`` rows or ``_INT8_MIN_DIM`` in either width the
    plain product in ``dtype``; above, ``w`` quantized per output channel and
    ``x`` per tensor (float32 scales, ``round`` half to even, clipped to
    +-127), an exact int8 x int8 -> int32 product, then ``y * (sx * sw) +
    bias`` in float32, rounded to ``dtype``."""
    out_f, in_f = weight.shape
    rows = x.numel() // in_f
    if rows < _INT8_MIN_ROWS or in_f < _INT8_MIN_DIM or out_f < _INT8_MIN_DIM:
        return F.linear(x.to(dtype), weight.to(dtype), bias.to(dtype))
    wf = weight.float()
    sw = torch.clamp(torch.amax(wf.abs(), dim=1), min=1e-12) / 127.0
    qw = torch.clamp(torch.round(wf / sw[:, None]), -127, 127).to(torch.int8)
    xf = x.float()
    sx = torch.clamp(torch.amax(xf.abs()), min=1e-12) / 127.0
    qx = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    y = _int_mm(qx.reshape(rows, in_f), qw)
    y = y.float() * (sx * sw) + bias.float()
    return y.reshape(x.shape[:-1] + (out_f,)).to(dtype)


class Dense(nn.Linear):
    """Linear layer over the last axis, computed in ``dtype``; inside
    :func:`int8_dense_compute` through :func:`int8_linear` (``int8`` False
    keeps a layer out, as the JAX package keeps ``ZeroDense`` out)."""

    int8 = True

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.int8 and _INT8_DENSE.get():
            return int8_linear(x, self.weight, self.bias, dt)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ZeroDense(Dense):
    int8 = False

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, dtype=dtype)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class PointwiseConv1d(nn.Conv1d):
    """A kernel-1 Conv1d (the reference attention's ``qkv``/``proj_out``)
    applied as a linear layer over the last axis of ``[B, T, C]``. The weight
    keeps the reference's ``[O, I, 1]`` shape so checkpoints load unrenamed.
    The non-zero one is a ``Dense`` in the JAX package, so it takes
    :func:`int8_dense_compute`'s route; the zero one is a ``ZeroDense``
    there and does not."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 zero: bool = False):
        super().__init__(in_ch, out_ch, 1)
        self.compute_dtype = dtype
        self.int8 = not zero
        if zero:
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.int8 and _INT8_DENSE.get():
            return int8_linear(x, self.weight[:, :, 0], self.bias, dt)
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
