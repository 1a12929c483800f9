"""Weight gradient of a 3x3, stride-1, padding-1 conv: the plain PyTorch
version and its Hopper kernel.

Counterpart of the JAX package's weight-gradient prototype
(``tools/prototype_wgrad_kernel.py``, ``_wgrad_kernel`` :40 launched by
``pallas_wgrad`` :59):

    dW[ky, kx, c, o] = sum_{b, h, w} x_pad[b, h + ky, w + kx, c] * dy[b, h, w, o]

x ``[B, H, W, C]`` and dy ``[B, H, W, Co]`` NHWC (the port's activation
layout, what ``nn.primitives.Conv`` holds before its NCHW view); dW ``[3, 3,
C, Co]`` f32 (HWIO), as ``pallas_wgrad`` returns it. :func:`hwio_to_oihw`
gives torch's ``[Co, C, 3, 3]``, the layout of a conv weight's ``.grad``.

* :func:`conv_wgrad_reference` is the plain version: nine tap slices of the
  padded x, each an f32 ``einsum("bhwc,bhwo->co")``, a sample at a time. On
  the card it needs ``torch.backends.cuda.matmul.allow_tf32 = False``.
* :func:`conv_wgrad_sm90_cuda` launches the ``wgmma``/TMA body
  (``csrc/conv_wgrad_sm90.cu``: bf16, C and Co multiples of 8) and counts its
  launches.
* :func:`conv_wgrad_cuda` launches the earlier ``mma.sync`` body and the
  float32 kernel (``csrc/conv_wgrad.cu``: any C and Co) and counts its
  launches.
* :func:`wgrad_route` is the plan: which of the two bodies, or cuDNN, takes a
  shape, from the card's per-site sweep.
* :func:`conv_wgrad` is the entry: for CUDA tensors the body the route picks
  (a shape routed to cuDNN raises), the plain version for CPU tensors.
* :class:`Conv3x3Fn` / :func:`conv3x3` route it into the conv backward: a 3x3
  stride-1 conv whose forward is cuDNN's and whose weight gradient is this
  kernel where the route picks one (``nn.primitives.Conv`` on the card).

The JAX package leaves its conv backward to XLA; its Pallas kernel is a
prototype that nothing routes.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops.attention import _dense16

__all__ = ["conv_wgrad_reference", "conv_wgrad_cuda", "conv_wgrad_sm90_cuda", "conv_wgrad",
           "wgrad_route", "hwio_to_oihw", "splits", "splits_sm90", "Conv3x3Fn", "conv3x3"]

_KERNEL = "conv_wgrad"
_KERNEL_SM90 = "conv_wgrad_sm90"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_ARGTYPES_SM90 = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
# the kernels' dy tile (rows x columns) and channel tile, as in csrc/conv_wgrad.cu
# and csrc/conv_wgrad_sm90.cu (kTH, kTW, kCT)
TILE_H, TILE_W, TILE_C = 8, 16, 64


def hwio_to_oihw(dw: torch.Tensor) -> torch.Tensor:
    """``[3, 3, C, Co]`` (HWIO) -> torch's conv weight layout ``[Co, C, 3, 3]``."""
    return dw.permute(3, 2, 0, 1)


def conv_wgrad_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The weight gradient in f32 torch ops: x ``[B, H, W, C]``, dy ``[B, H, W,
    Co]`` -> ``[3, 3, C, Co]`` float32. Pads x, then sums nine tap products
    over the pixels, one sample at a time (the padded f32 copy of a 256 px
    sample at C 128 is 34 MB, of the batch 8 times that)."""
    b, h, w, c = x.shape
    co = dy.shape[-1]
    if dy.shape[:3] != x.shape[:3]:
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} differ in [B, H, W]")
    dw = torch.zeros(3, 3, c, co, dtype=torch.float32, device=x.device)
    for i in range(b):
        xp = torch.nn.functional.pad(x[i].float(), (0, 0, 1, 1, 1, 1))  # [H + 2, W + 2, C]
        g = dy[i].float()
        for ky in range(3):
            for kx in range(3):
                dw[ky, kx] += torch.einsum("hwc,hwo->co", xp[ky:ky + h, kx:kx + w], g)
    return dw


def splits(b: int, h: int, w: int, c: int, co: int, sms: int) -> int:
    """How many blocks share the pixel contraction of one (c, o) tile: about
    one block an SM over all tiles, at most one dy tile a block."""
    pairs = -(-c // TILE_C) * -(-co // TILE_C)
    tiles = b * -(-h // TILE_H) * -(-w // TILE_W)
    return max(1, min(tiles, sms // pairs))


# the split planner's model of the wgmma body on the H100 80GB HBM3 at 700 W:
# a block's products at the rate the body reached at the JAX tool's shape
# (769 TFLOP/s over 132 SMs), the partials written and read once more at
# about the memory's rate, and the summing kernel's launch
SM90_FLOPS_PER_BLOCK = 5.8e12
SM90_WORKSPACE_BYTES_PER_S = 3.0e12
SM90_SUM_LAUNCH_S = 3e-6


@functools.lru_cache(maxsize=None)
def splits_sm90(b: int, h: int, w: int, c: int, co: int, sms: int) -> int:
    """How many blocks share the pixel contraction of one (c, o) tile in the
    ``wgmma`` body (one block an SM): the S of the least modelled time,
    ``ceil(pairs * S / sms)`` waves of ``1 / S`` of a tile pair's products
    each, plus, for S > 1, the ``[S, 9, C, Co]`` f32 partials written and
    read again and the summing kernel's launch; the smallest S of a tie, at
    most one dy tile a block and four blocks an SM. Cached per shape: the
    wrapper asks at every launch."""
    pairs = -(-c // TILE_C) * -(-co // TILE_C)
    tiles = b * -(-h // TILE_H) * -(-w // TILE_W)
    work = 2.0 * b * h * w * 9 * TILE_C * TILE_C / SM90_FLOPS_PER_BLOCK
    partial = 2.0 * 9 * c * co * 4 / SM90_WORKSPACE_BYTES_PER_S

    def seconds(s: int) -> float:
        return -(-pairs * s // sms) * work / s + (s * partial + SM90_SUM_LAUNCH_S) * (s > 1)

    return min(range(1, min(tiles, max(1, 4 * sms // pairs)) + 1), key=lambda s: (seconds(s), s))


def _check(x: torch.Tensor, dy: torch.Tensor):
    if not (x.is_cuda and dy.is_cuda):
        raise ValueError("conv_wgrad_cuda needs CUDA tensors")
    if x.dtype not in (torch.bfloat16, torch.float32) or dy.dtype != x.dtype:
        raise ValueError(f"x and dy must share one dtype, bf16 or float32; got {x.dtype}, "
                         f"{dy.dtype}")
    if x.device != dy.device:
        raise ValueError("x and dy must be on one device")
    if x.dim() != 4 or dy.dim() != 4 or dy.shape[:3] != x.shape[:3]:
        raise ValueError(f"x [B, H, W, C] and dy [B, H, W, Co] expected, got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    if min(*x.shape, dy.shape[-1]) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}, {tuple(dy.shape)}")
    if x.shape[0] * x.shape[1] * x.shape[2] >= 2**31:
        raise ValueError("more than 2^31 pixels")
    return (*x.shape, dy.shape[-1])


def conv_wgrad_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Launch the weight-gradient kernel on CUDA tensors x ``[B, H, W, C]``
    and dy ``[B, H, W, Co]`` (bf16 or float32, any C and Co; non-contiguous
    inputs are copied). Returns dW ``[3, 3, C, Co]`` float32. Raises on
    anything the kernel does not take and on a failed launch; never falls
    back."""
    b, h, w, c, co = _check(x, dy)
    x, dy = _dense16(x), _dense16(dy)
    fn = getattr(_build.load(_KERNEL), "eo_conv_wgrad")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    is_f32 = x.dtype == torch.float32
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if is_f32:  # the FMA kernel: one thread per (tap, c, o); about two blocks an SM
        s = max(1, min(64, 2 * sms // -(-9 * c * co // 256)))
    else:
        s = splits(b, h, w, c, co, sms)
    out = torch.empty(3, 3, c, co, dtype=torch.float32, device=x.device)
    ws = torch.empty(s * 9 * c * co if s > 1 else 0, dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), dy.data_ptr(), out.data_ptr(), ws.data_ptr(), int(is_f32), b, h, w,
            c, co, s, x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_wgrad launch failed: error {rc}")
    conv_wgrad_cuda.launches += 1
    return out


conv_wgrad_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def conv_wgrad_sm90_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Launch the ``wgmma``/TMA weight-gradient kernel on CUDA tensors x
    ``[B, H, W, C]`` and dy ``[B, H, W, Co]``, bf16, C and Co multiples of 8
    (non-contiguous inputs are copied), with :func:`splits_sm90`'s splits.
    Returns dW ``[3, 3, C, Co]`` float32. Raises on anything the
    kernel does not take and on a failed launch; never falls back."""
    b, h, w, c, co = _check(x, dy)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv_wgrad_sm90_cuda takes bf16, got {x.dtype}")
    if c % 8 or co % 8:
        raise ValueError(f"conv_wgrad_sm90_cuda needs C and Co multiples of 8 (16-byte TMA "
                         f"rows), got C {c}, Co {co}")
    x, dy = _dense16(x), _dense16(dy)
    fn = getattr(_build.load(_KERNEL_SM90), "eo_conv_wgrad_sm90")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES_SM90, ctypes.c_int
    s = splits_sm90(b, h, w, c, co, _sms(x.device))
    out = torch.empty(3, 3, c, co, dtype=torch.float32, device=x.device)
    ws = torch.empty(s * 9 * c * co if s > 1 else 0, dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), dy.data_ptr(), out.data_ptr(), ws.data_ptr(), b, h, w, c, co, s,
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_wgrad_sm90 launch failed: error {rc}")
    conv_wgrad_sm90_cuda.launches += 1
    return out


conv_wgrad_sm90_cuda.launches = 0


# (pixels B*H*W, C, Co) where the card's sweep timed cuDNN's weight gradient
# below the wgmma body's: ms, body / cuDNN (tools/prototype_wgrad_kernel.py
# --sites unet256 and unet512 on an H100 80GB HBM3 at 700 W; PERF.md section 6).
# The six are the clouds UNet's level-3 inputs (Co 512 from C 384 or 896: 48
# or 112 tile pairs fill the card badly), its ten 32 x 32 C512 -> 512 sites at
# batch 8, and one 64 x 64 C256 -> 384 site, the last two within 1 %
CUDNN_FASTER = {
    (8 * 32 * 32, 384, 512): (0.05803, 0.05055),
    (8 * 32 * 32, 896, 512): (0.09429, 0.08680),
    (8 * 32 * 32, 512, 512): (0.06160, 0.06140),  # means over the ten sites
    (8 * 64 * 64, 256, 384): (0.08793, 0.08731),
    (4 * 64 * 64, 384, 512): (0.10126, 0.08519),
    (4 * 64 * 64, 896, 512): (0.17959, 0.16826),
}


def wgrad_route(b: int, h: int, w: int, c: int, co: int, dtype: torch.dtype) -> str:
    """Which implementation computes the weight gradient of a 3x3 stride-1
    conv of this shape on the card: ``"sm90"`` (:func:`conv_wgrad_sm90_cuda`),
    ``"mma"`` (:func:`conv_wgrad_cuda`) or ``"cudnn"`` (the conv's own
    autograd). Decided from the shape alone, before any launch: a plan, not a
    fallback.

    The rule, from the card's sweep over the 49 stride-1 3x3 sites of a
    ``sen12mscr256`` training step at 256 px batch 8 and 512 px batch 4 (44
    distinct shapes): bf16 with C and Co multiples of 8 takes the ``wgmma``
    body, except the shapes in :data:`CUDNN_FASTER`. The body was faster at
    the other 38 shapes, by 3-43 % (0.20233 against 0.21682 ms at the JAX
    tool's B8 256 x 256 C128 -> 128; 0.26850 against 0.43580 at B8 64 x 64
    C896 -> 384); shapes the sweep has not timed take it too. Everything
    else goes to cuDNN: float32 (the FMA kernel is a check, not a fast
    path), and the input and output convs' C 6 and Co 3, where the
    ``mma.sync`` body took 2.1x / 1.5x cuDNN's time (0.36853 / 0.32549
    against 0.17321 / 0.21384 ms at 256 px on the same card)."""
    if dtype != torch.bfloat16 or c % 8 or co % 8:
        return "cudnn"
    if (b * h * w, c, co) in CUDNN_FASTER:
        return "cudnn"
    return "sm90"


def conv_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The 3x3 conv weight gradient ``[3, 3, C, Co]`` float32 from NHWC x and
    dy: for CUDA tensors the kernel :func:`wgrad_route` picks (a shape it
    gives to cuDNN raises), for CPU tensors the plain version."""
    if x.is_cuda:
        route = wgrad_route(*x.shape, dy.shape[-1], x.dtype)
        if route == "sm90":
            return conv_wgrad_sm90_cuda(x, dy)
        if route == "mma":
            return conv_wgrad_cuda(x, dy)
        raise ValueError(f"wgrad_route gives x {tuple(x.shape)} dy {tuple(dy.shape)} "
                         f"{x.dtype} to cuDNN; no kernel takes it")
    if x.device.type != "cpu":
        raise ValueError(f"no conv weight-gradient kernel for device {x.device}")
    return conv_wgrad_reference(x, dy)


class Conv3x3Fn(torch.autograd.Function):
    """A 3x3, stride-1, padding-1 conv on NHWC x whose weight gradient is
    :func:`conv_wgrad`.

    ``forward(x, weight, bias, dtype)`` with x ``[N, H, W, C]`` in ``dtype``,
    weight ``[Co, C, 3, 3]`` and bias ``[Co]`` float32 parameters: cuDNN's
    conv in ``dtype`` on the NCHW view, as ``nn.primitives.Conv`` computes it.
    Backward: dx by cuDNN (``aten.convolution_backward``, input gradient
    only), dW by :func:`conv_wgrad` returned in float32 (summed in f32 and
    rounded nowhere, where autograd's goes through ``dtype`` once), db the
    float32 sum of dy over the pixels."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype):
        w = weight.to(dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, bias.to(dtype), 1, 1)
        ctx.save_for_backward(x, w)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # output_mask is (input, weight, bias)
            dx = torch.ops.aten.convolution_backward(
                dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [1, 1], [1, 1],
                [1, 1], False, [0, 0], 1, [True, False, False])[0].permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = hwio_to_oihw(conv_wgrad(x, dy)).contiguous()
        if ctx.needs_input_grad[2]:  # summed in f32 from dy as it is: no f32 copy of dy
            db = dy.sum((0, 1, 2), dtype=torch.float32)
        return dx, dw, db, None


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
            impl: str = "auto") -> torch.Tensor:
    """A 3x3, stride-1, padding-1 conv of NHWC x computed in ``dtype``.
    ``impl="auto"``: on the card, while a weight gradient is to be taken and
    :func:`wgrad_route` gives the shape to a kernel, through
    :class:`Conv3x3Fn`; otherwise (CPU tensors, ``impl="plain"``, no
    gradient, a shape cuDNN takes) cuDNN's conv under ordinary autograd."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    x = x.to(dtype)
    if (impl == "auto" and x.is_cuda and torch.is_grad_enabled() and weight.requires_grad
            and wgrad_route(*x.shape, weight.shape[0], dtype) != "cudnn"):
        return Conv3x3Fn.apply(x, weight, bias, dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(dtype), bias.to(dtype), 1, 1)
    return y.permute(0, 2, 3, 1)
