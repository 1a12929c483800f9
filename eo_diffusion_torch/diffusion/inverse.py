"""DDNM zero-shot restoration in PyTorch: linear inverse problems solved
with a plain trained DDPM (Wang et al. 2023, arXiv:2212.00490).

Counterpart of ``eo_diffusion_tpu/diffusion/inverse.py``. Given y = A(x)
for a known linear degradation A with pseudo-inverse A+, every reverse DDIM
step replaces the range-space part of the predicted clean image,

    x0_hat = A+ y + (I - A+ A) x0_pred,

so A(x0_hat) = y while the diffusion prior fills the null space. The
operators are closed-form tensor maps (box pooling, masking, channel means)
applied through :meth:`GaussianDiffusion.ddim_sample`'s ``x0_proj`` hook.
Tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from eo_diffusion_torch.diffusion.gaussian import DenoiseFn, DiffusionOutput, GaussianDiffusion

__all__ = ["LinearOperator", "sr_operator", "inpaint_operator", "gray_operator",
           "ddnm_projector", "ddnm_sample"]


@dataclasses.dataclass(frozen=True)
class LinearOperator:
    """A linear degradation A and its Moore-Penrose pseudo-inverse A+, with
    A(A+(y)) == y on A's range."""

    forward: Callable[[torch.Tensor], torch.Tensor]  # A
    pinv: Callable[[torch.Tensor], torch.Tensor]     # A+
    name: str = "linear"


def sr_operator(factor: int) -> LinearOperator:
    """Box downsampling A (factor x factor mean pool); A+ = nearest upsample
    (the rows of A are orthogonal with squared norm 1/factor^2)."""
    assert factor >= 1

    def fwd(x):
        n, h, w, c = x.shape
        assert h % factor == 0 and w % factor == 0, (h, w, factor)
        return x.reshape(n, h // factor, factor, w // factor, factor, c).mean(dim=(2, 4))

    def pinv(y):
        return y.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)

    return LinearOperator(fwd, pinv, name=f"sr{factor}")


def inpaint_operator(mask: torch.Tensor) -> LinearOperator:
    """Masking A (mask 1 = observed); A+ is the same mask."""
    m = torch.as_tensor(mask, dtype=torch.float32)
    return LinearOperator(lambda x: x * m.to(x.device), lambda y: y * m.to(y.device),
                          name="inpaint")


def gray_operator(channels: int = 3) -> LinearOperator:
    """Channel-mean A (grayscale); A+ replicates the gray value. Restoring
    through it is zero-shot colorization."""
    return LinearOperator(lambda x: x.mean(dim=-1, keepdim=True),
                          lambda y: y.repeat_interleave(channels, dim=-1), name="gray")


def ddnm_projector(op: LinearOperator, y: torch.Tensor) -> Callable:
    """The per-step x0 replacement ``x0 - A+ A x0 + A+ y`` (Alg. 1 line 5)."""
    y = y.float()
    pinv_y = op.pinv(y)

    def proj(x0):
        return x0 - op.pinv(op.forward(x0)) + pinv_y

    return proj


def ddnm_sample(diffusion: GaussianDiffusion, model_fn: DenoiseFn, y: torch.Tensor,
                op: LinearOperator, num_steps: int = 100, eta: float = 0.85,
                clip: bool = True, **kw: Any) -> DiffusionOutput:
    """Restore x from the observation ``y`` (in A's output space, e.g. the
    low-res image of :func:`sr_operator`) with a plain DDPM. Batch and shape
    come from ``A+ y``. ``eta=0.85`` is the paper's default; ``clip`` clamps
    pred_x0 before the projection. ``kw`` (``device``, ``generator``,
    ``x_T``, ``noise_fn``, ...) goes to ``ddim_sample``. The sample is
    projected once more at the end, so ``A(x) = y`` holds exactly."""
    x_init = op.pinv(y.float())
    assert x_init.shape[1] == diffusion.image_size and \
        x_init.shape[-1] == diffusion.in_channels, (
            f"A+ y has shape {tuple(x_init.shape)}; the process expects "
            f"{diffusion.image_size}px x {diffusion.in_channels}ch")
    proj = ddnm_projector(op, y)
    kw.setdefault("device", y.device)
    out = diffusion.ddim_sample(model_fn, x_init.shape[0], num_steps=num_steps, eta=eta,
                                clip=clip, x0_proj=proj, **kw)
    return DiffusionOutput(x=proj(out.x), intermediates=out.intermediates)
