"""Few-step distillation of rectified flows (ReFlow), in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/distill.py`` (Liu et al.,
arXiv:2209.03003 section 3.2):

1. simulate the teacher ODE from fixed noise ``eps`` to get deterministic
   couplings ``(eps, x1)`` (:func:`generate_couplings`);
2. re-fit the same flow objective on the paired endpoints
   (``FlowMatching.train_loss(noise=eps)``, fed by :func:`coupling_batches`):
   the marginals stay, the paths straighten, and Euler with 1-4 steps lands
   where the teacher needed 16-32.

:func:`straightness` and :func:`endpoint_gap` score a field;
:func:`cfg_model_fn` folds classifier-free guidance into one callable, the
guided teacher of guidance distillation (Meng et al., arXiv:2210.03142).
The coupling set is a dataset on the host (numpy), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from eo_diffusion_torch.diffusion.flow import FlowMatching
from eo_diffusion_torch.diffusion.gaussian import guided_combine

__all__ = ["generate_couplings", "coupling_batches", "straightness", "endpoint_gap",
           "cfg_model_fn"]


def cfg_model_fn(model_fn: Callable, scale: float, null_y: int,
                 guidance_rescale: float = 0.0) -> Callable:
    """Classifier-free guidance as one ``model_fn(x, t, cond, y)``: the
    conditional and the null-class (index ``null_y``) calls combined by
    :func:`~eo_diffusion_torch.diffusion.gaussian.guided_combine` in float32
    (``guidance_rescale`` the std rescue of arXiv:2305.08891)."""
    def fn(x, t, cond=None, y=None):
        assert y is not None, "guided teacher needs class labels"
        e_c = model_fn(x, t, cond, y).float()
        e_u = model_fn(x, t, cond, torch.full_like(y, null_y)).float()
        return guided_combine(e_u, e_c, scale, guidance_rescale)

    return fn


def _pad_to_batch(a: Optional[torch.Tensor], batch_size: int) -> Optional[torch.Tensor]:
    """Tile ``a`` along axis 0 to ``batch_size`` rows (None and full arrays
    pass through)."""
    if a is None or a.shape[0] >= batch_size:
        return a
    reps = -(-batch_size // a.shape[0])
    return a.repeat((reps,) + (1,) * (a.ndim - 1))[:batch_size]


@torch.no_grad()
def generate_couplings(flow: FlowMatching, model_fn: Callable, n: int, *, device,
                       generator: Optional[torch.Generator] = None, num_steps: int = 32,
                       method: str = "heun", batch_size: int = 64,
                       cond: Optional[np.ndarray] = None, y: Optional[np.ndarray] = None,
                       dtype: torch.dtype = torch.float32,
                       eps: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate the teacher ODE from fixed noise: ``(eps, x1)`` float32 numpy
    arrays of ``n`` couplings, in ``ceil(n / batch_size)`` chunks of
    ``batch_size`` (a ragged tail is tiled up to a full chunk and cut off).
    ``cond`` / ``y`` are full-length ``[n, ...]`` arrays sliced per chunk;
    ``eps`` ``[n, H, W, C]`` replaces the noise, drawn a chunk at a time
    from ``generator`` otherwise."""
    shape = (batch_size, flow.image_size, flow.image_size, flow.in_channels)
    eps_all, x1_all = [], []
    for i in range(-(-n // batch_size)):
        part = slice(i * batch_size, (i + 1) * batch_size)
        c, yy, e = (None if a is None else torch.tensor(a[part], device=device)
                    for a in (cond, y, eps))
        c, yy, e = (_pad_to_batch(a, batch_size) for a in (c, yy, e))
        if e is None:
            e = torch.randn(shape, generator=generator, device=device)
        e = e.float()
        x1 = flow.sample(model_fn, batch_size, device=device, num_steps=num_steps,
                         method=method, x_T=e, cond=c, y=yy, dtype=dtype).x
        eps_all.append(e.cpu().numpy())
        x1_all.append(x1.float().cpu().numpy())
    return np.concatenate(eps_all)[:n], np.concatenate(x1_all)[:n]


def coupling_batches(eps: np.ndarray, x1: np.ndarray, batch_size: int, seed: int = 0,
                     cond: Optional[np.ndarray] = None,
                     y: Optional[np.ndarray] = None) -> Iterator[dict]:
    """Endless shuffled paired batches (numpy, the JAX package's draws): the
    teacher endpoint as "image", the paired noise as "noise" (which pins the
    eps of ``FlowMatching.train_loss``), with "cond" / "label" rows when
    given."""
    assert len(eps) == len(x1), (len(eps), len(x1))
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, len(eps), batch_size)
        batch = {"image": x1[idx], "noise": eps[idx]}
        if cond is not None:
            batch["cond"] = cond[idx]
        if y is not None:
            batch["label"] = y[idx]
        yield batch


@torch.no_grad()
def straightness(flow: FlowMatching, model_fn: Callable, eps: torch.Tensor, x1: torch.Tensor,
                 num_probe: int = 8, cond: Optional[torch.Tensor] = None,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared deviation of the field from the chord velocity, ``E_t
    ||v((1 - t) x1 + t eps, t) - (eps - x1)||^2`` over ``num_probe``
    midpoint times: zero iff the flow moves every coupling on a straight
    line (1-step Euler exact). A 0-dim float32 tensor."""
    epsf, x1f = eps.float(), x1.float()
    chord = epsf - x1f
    ts = (torch.arange(num_probe, dtype=torch.float32, device=epsf.device) + 0.5) / num_probe
    total = torch.zeros((), dtype=torch.float32, device=epsf.device)
    for t in ts:
        x_t = (1.0 - t) * x1f + t * epsf
        tt = (t * flow.time_scale).expand(x_t.shape[0])
        v = model_fn(x_t, tt, cond, y).float()
        total = total + ((v - chord) ** 2).mean()
    return total / num_probe


@torch.no_grad()
def endpoint_gap(flow: FlowMatching, model_fn: Callable, eps: torch.Tensor,
                 few_steps: int = 1, ref_steps: int = 64, cond: Optional[torch.Tensor] = None,
                 y: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """RMS distance between the ``few_steps`` Euler endpoint and the same
    model's Heun-``ref_steps`` endpoint from the same noise: the few-step
    integration error distillation removes. A 0-dim float32 tensor."""
    n = eps.shape[0]
    kw = dict(device=eps.device, x_T=eps, cond=cond, y=y, dtype=dtype)
    few = flow.sample(model_fn, n, num_steps=few_steps, method="euler", **kw).x
    ref = flow.sample(model_fn, n, num_steps=ref_steps, method="heun", **kw).x
    return torch.sqrt(((few - ref) ** 2).mean())
