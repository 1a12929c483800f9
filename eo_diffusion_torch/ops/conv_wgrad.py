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
* :func:`conv_wgrad_cuda` launches the hand-written CUDA kernel
  (``csrc/conv_wgrad.cu``) and counts its launches.
* :func:`conv_wgrad` is the entry: the kernel for CUDA tensors (or a raise),
  the plain version for CPU tensors.

Nothing routes the kernel into the conv backward: the JAX package leaves its
conv backward to XLA and the port leaves it to cuDNN (ROADMAP queue 2, item 3
holds the candidate with its measured gap).
"""

from __future__ import annotations

import ctypes

import torch

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops.attention import _dense16

__all__ = ["conv_wgrad_reference", "conv_wgrad_cuda", "conv_wgrad", "hwio_to_oihw", "splits"]

_KERNEL = "conv_wgrad"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
# the kernel's dy tile (rows x columns) and channel tile, as in csrc/conv_wgrad.cu
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


def conv_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The 3x3 conv weight gradient ``[3, 3, C, Co]`` float32 from NHWC x and
    dy: the CUDA kernel for CUDA tensors (or a raise), the plain version for
    CPU tensors."""
    if x.is_cuda:
        return conv_wgrad_cuda(x, dy)
    if x.device.type != "cpu":
        raise ValueError(f"no conv weight-gradient kernel for device {x.device}")
    return conv_wgrad_reference(x, dy)
