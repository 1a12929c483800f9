"""Muon: momentum + Newton-Schulz orthogonalisation for matrix parameters
(counterpart of ``eo_diffusion_tpu/train/muon.py``; Jordan et al. 2024, as
scaled up in Liu et al., arXiv:2502.16982).

SGD with Nesterov momentum whose update of each matrix-shaped parameter is
replaced by its nearest (semi-)orthogonal matrix, from a quintic
Newton-Schulz iteration (five products a matrix a step, in float32); every
other parameter (biases, norm scales, embedding tables) takes AdamW with
weight decay 1e-4, under the same learning-rate schedule. The Muon group
reads the schedule times ``muon_lr_mult`` (``lr_schedules.set_lr`` honours
each group's ``lr_mult``).

Orientation and labels follow the JAX package's flax view, not the torch
tensors: a parameter is a matrix when its flax leaf has two or more axes, the
matrix being the flax leaf reshaped to ``[-1, last axis]`` (Dense ``[in,
out]``, a conv's HWIO as ``[h*w*in, out]``, an MoE expert stack ``[E, in,
out]`` as ``[E*in, out]``, the attention's ``qkv`` ``[in, out]``, which is a
3-D ``[out, in, 1]`` Conv1d weight in torch), and a path that contains
``embedding`` or ``label_emb`` goes to AdamW. The RMS scale ``sqrt(max(1,
rows / cols))`` is not symmetric in rows and columns, so each update is
orthogonalised in that view and carried back through the layout's torch
twins (``weights.torch_transforms``). The products run with TF32 off.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
from torch import nn

__all__ = ["newton_schulz5", "orthogonalized_update", "muon_labels", "MuonWithAdamW"]

# the quintic iteration's coefficients from the official Muon implementation
# (the singular values converge to about [0.7, 1.2], by design)
_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz5(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Approximate semi-orthogonalisation of a 2-D matrix: G -> UV^T. Five
    iterations of X <- aX + (bA + cA^2)X with A = XX^T after a Frobenius
    normalisation; a tall matrix is transposed so that the Gram matrix is
    the small one."""
    assert g.ndim == 2, g.shape
    a, b, c = _NS_COEFFS
    x = g / (torch.linalg.vector_norm(g) + eps)
    transpose = x.shape[0] > x.shape[1]
    if transpose:
        x = x.T
    for _ in range(steps):
        gram = x @ x.T
        x = a * x + (b * gram + c * gram @ gram) @ x
    return x.T if transpose else x


def orthogonalized_update(g: torch.Tensor, ns_steps: int = 5) -> torch.Tensor:
    """One leaf in its flax view, orthogonalised: reshaped to ``[-1, last
    axis]``, Newton-Schulz in float32, scaled by ``sqrt(max(1, rows /
    cols))`` and reshaped back."""
    shape = g.shape
    m = g.reshape(-1, shape[-1]) if g.ndim > 2 else g
    o = newton_schulz5(m.float(), ns_steps)
    o = o * max(1.0, m.shape[0] / m.shape[1]) ** 0.5
    return o.reshape(shape).to(g.dtype)


def muon_labels(model: nn.Module) -> Dict[str, Tuple[str, object]]:
    """Parameter name -> ``(label, to_flax)``: ``"muon"`` for a leaf of two or
    more axes in the flax view whose path names no embedding table,
    ``"adamw"`` otherwise (JAX ``muon_label_fn``); ``to_flax`` is the layout
    entry's numpy transform, which names its torch twins."""
    from eo_diffusion_torch.weights import flax_shape, keystr, model_layout

    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out = {}
    for fpath, tname, _, inv in model_layout(model):
        path = keystr(("params",) + tuple(fpath)).lower()
        matrix = len(flax_shape(shapes[tname], inv)) >= 2
        label = "adamw" if ("embedding" in path or "label_emb" in path) else (
            "muon" if matrix else "adamw")
        out[tname] = (label, inv)
    missing = set(shapes) - set(out)
    assert not missing, f"no flax layout for {sorted(missing)}"
    return out


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class MuonWithAdamW(torch.optim.Optimizer):
    """Muon on the matrix parameters of ``model``, AdamW on the rest (JAX
    ``muon_with_adamw``): two parameter groups, ``kind`` ``"muon"`` (its
    ``lr_mult`` is ``muon_lr_mult``, no weight decay) and ``"adamw"`` (b1
    0.9, b2 0.999, eps 1e-8, decoupled weight decay ``weight_decay``). The
    Muon group's ``views`` name each parameter's layout transform, so the
    state round-trips through ``state_dict`` (the momentum buffers
    included)."""

    def __init__(self, model: nn.Module, lr: float, muon_lr_mult: float = 1.0,
                 momentum: float = 0.95, nesterov: bool = True, ns_steps: int = 5,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        from eo_diffusion_torch.weights import _TWIN

        labels = muon_labels(model)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        muon = [(n, p) for n, p in named if labels[n][0] == "muon"]
        adam = [p for n, p in named if labels[n][0] == "adamw"]
        groups = [g for g in (
            {"params": [p for _, p in muon], "kind": "muon", "lr_mult": muon_lr_mult,
             "views": [_TWIN[labels[n][1]] for n, _ in muon]},
            {"params": adam, "kind": "adamw", "lr_mult": 1.0}) if g["params"]]
        defaults = dict(lr=lr, lr_mult=1.0, momentum=momentum, nesterov=nesterov,
                        ns_steps=ns_steps, betas=betas, eps=eps, weight_decay=weight_decay)
        super().__init__(groups, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            if group["kind"] == "muon":
                self._muon(group)
            else:
                self._adamw(group)
        return loss

    def _muon(self, group) -> None:
        from eo_diffusion_torch.weights import torch_transforms

        mom, lr = group["momentum"], group["lr"]
        with _no_tf32():
            for p, view in zip(group["params"], group["views"]):
                if p.grad is None:
                    continue
                g = p.grad.float()
                st = self.state[p]
                if "momentum_buffer" not in st:
                    st["momentum_buffer"] = torch.zeros_like(p, dtype=torch.float32)
                buf = st["momentum_buffer"]
                buf.mul_(mom).add_(g)
                eff = g + mom * buf if group["nesterov"] else buf
                to_torch, to_flax = torch_transforms(view)
                o = to_torch(orthogonalized_update(to_flax(eff), group["ns_steps"]))
                p.add_(o.to(p.dtype), alpha=-lr)

    def _adamw(self, group) -> None:
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        for p in group["params"]:
            if p.grad is None:
                continue
            g = p.grad.float()
            st = self.state[p]
            if "step" not in st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            st["step"] += 1
            t = float(st["step"])
            m, v = st["exp_avg"], st["exp_avg_sq"]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            # optax.adamw: m_hat / (sqrt(v_hat) + eps) + wd * p, times -lr
            u = (m / (1.0 - b1 ** t)) / ((v / (1.0 - b2 ** t)).sqrt() + eps)
            p.add_(u + wd * p, alpha=-lr)

