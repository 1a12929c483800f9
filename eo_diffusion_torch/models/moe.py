"""Mixture-of-Experts FFN for the DiT (counterpart of ``eo_diffusion_tpu/models/moe.py``).

Token-choice top-k routing with a fixed per-expert capacity (GShard,
arXiv:2006.16668; Switch Transformer, arXiv:2101.03961), with the JAX
package's rules:

* the router is a float32 ``Dense`` on a float32 cast of the tokens; softmax,
  then the top k experts (a stable descending sort: on equal probabilities
  the lower expert index first, as ``jax.lax.top_k``), the k gates
  renormalised with ``max(sum, 1e-9)``;
* capacity ``C = max(int(round(S * k / E * capacity)), 1)`` over the ``S =
  B * T`` tokens of the call; slot by slot, each token queues behind every
  token of the earlier slots and the earlier tokens of its own; a token past
  capacity is dropped for that slot (the block's gated residual still
  carries it);
* the load-balance aux value ``E * sum_e f_e * P_e`` from the top-1
  assignment and the mean router probability.

The JAX package dispatches and combines through dense ``[S, E, C]`` one-hot
einsums, the TPU's idiom. Here they are an index copy into ``[E, C, d]``
buffers and a gather back: the same numbers (dispatch moves each token
unchanged; combine rounds each gate to the compute dtype as JAX's
``combine.astype(cdt)`` does, sums the at most k products in float32 and
rounds once). The experts' FFN is ``torch.bmm`` over the buffers, a plain
matmul as in JAX.

Parameters keep flax's names and layouts: ``router`` (a ``Dense``),
``w_in [E, d, h]``, ``b_in [E, h]``, ``w_out [E, h, d]``, ``b_out [E, d]``.
While the module is in training mode each forward appends its aux value to
``aux_values``; the trainer clears them once a step
(:func:`clear_moe_aux`) and reads their mean (:func:`moe_aux_mean`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eo_diffusion_torch.nn.primitives import Dense

__all__ = ["MoEMLP", "route", "assign_slots", "clear_moe_aux", "moe_aux_mean"]


def route(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The top-k experts ``[S, k]`` of each token, the lower index first on
    equal probabilities (a stable descending sort, as ``jax.lax.top_k``)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]


def assign_slots(experts: torch.Tensor, num_experts: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The queue position ``[S, k]`` of each (token, slot) in its expert, slot
    j queued behind every earlier slot, and whether it is within
    ``capacity`` ``[S, k]``."""
    filled = torch.zeros(num_experts, 1, dtype=torch.int32, device=experts.device)
    slots, keeps = [], []
    for j in range(experts.shape[1]):
        e = experts[:, j]
        # [E, S]: the running count along the last axis (a scan down the
        # first axis of [S, E] runs one thread a column on the card)
        onehot = F.one_hot(e, num_experts).to(torch.int32).t()
        pos = torch.gather(torch.cumsum(onehot, dim=1) - 1 + filled, 0, e[None])[0]
        keep = pos < capacity
        filled = filled + (onehot * keep[None]).sum(1, keepdim=True, dtype=torch.int32)
        slots.append(pos.long())
        keeps.append(keep)
    return torch.stack(slots, 1), torch.stack(keeps, 1)


class MoEMLP(nn.Module):
    """Drop-in for the DiT block's dense MLP: ``[B, T, d] -> [B, T, d]``.

    ``inject_experts`` (a ``[S, k]`` tensor, or None) replaces the router's
    choice of experts, the gates still coming from this call's
    probabilities; ``record_experts`` keeps the last call's choice in
    ``last_experts``. Both are for holding two runs of a model on one
    routing, and are off on every entry point."""

    def __init__(self, hidden: int, mlp_hidden: int, num_experts: int, top_k: int = 1,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        assert 1 <= top_k <= num_experts, (top_k, num_experts)
        self.num_experts, self.top_k, self.capacity_factor = num_experts, top_k, capacity_factor
        self.compute_dtype = dtype
        self.router = Dense(hidden, num_experts)
        e = num_experts
        # flax lecun_normal on [E, fan, out]: variance 1 / (E * fan)
        self.w_in = nn.Parameter(nn.init.trunc_normal_(torch.empty(e, hidden, mlp_hidden),
                                                       std=1 / math.sqrt(e * hidden)))
        self.b_in = nn.Parameter(torch.zeros(e, mlp_hidden))
        self.w_out = nn.Parameter(nn.init.trunc_normal_(torch.empty(e, mlp_hidden, hidden),
                                                        std=1 / math.sqrt(e * mlp_hidden)))
        self.b_out = nn.Parameter(torch.zeros(e, hidden))
        self.aux_values: List[torch.Tensor] = []
        self.inject_experts: Optional[torch.Tensor] = None
        self.record_experts = False
        self.last_experts: Optional[torch.Tensor] = None

    def capacity(self, tokens: int) -> int:
        return max(int(round(tokens * self.top_k / self.num_experts * self.capacity_factor)), 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        n_exp, k, cdt = self.num_experts, self.top_k, self.compute_dtype
        s = b * t
        cap = self.capacity(s)
        xf = x.reshape(s, d)
        probs = torch.softmax(self.router(xf.float()), dim=-1)  # [S, E] float32
        experts = (route(probs, k) if self.inject_experts is None
                   else self.inject_experts.to(x.device))
        slot, keep = assign_slots(experts, n_exp, cap)
        if self.record_experts:
            self.last_experts = experts
        gates = torch.gather(probs, 1, experts)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        if self.training:
            top1 = F.one_hot(experts[:, 0], n_exp).float()
            self.aux_values.append(n_exp * (top1.mean(0) * probs.mean(0)).sum())

        # dispatch: every kept (token, slot) into its expert's row; a dropped
        # one into a spare last row that is cut off (no boolean mask, so no
        # wait for the device to count the kept ones)
        rows = experts * cap + slot  # [S, k]
        spare = n_exp * cap
        xe = xf.new_zeros(spare + 1, d, dtype=cdt).index_put(
            (torch.where(keep, rows, spare).reshape(-1),),
            xf.to(cdt)[:, None, :].expand(s, k, d).reshape(s * k, d))
        h = torch.bmm(xe[:spare].reshape(n_exp, cap, d), self.w_in.to(cdt))
        h = F.gelu(h + self.b_in[:, None, :].to(cdt), approximate="tanh")
        oe = torch.bmm(h, self.w_out.to(cdt)) + self.b_out[:, None, :].to(cdt)
        # combine: the gate rounded to the compute dtype times its expert's row,
        # summed over the slots in float32, rounded once
        picked = oe.reshape(n_exp * cap, d)[torch.where(keep, rows, 0)]  # [S, k, d]
        w = (gates.to(cdt).float() * keep)[..., None]
        y = (w * picked.float()).sum(1)
        return y.to(cdt).reshape(b, t, d).to(x.dtype)


def _moes(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, MoEMLP)]


def clear_moe_aux(model: nn.Module) -> None:
    """Forget the aux values every MoE layer of ``model`` has recorded."""
    for m in _moes(model):
        m.aux_values.clear()


def moe_aux_mean(model: nn.Module) -> Optional[torch.Tensor]:
    """The mean of every aux value recorded since :func:`clear_moe_aux` (each
    layer's, each call's: a self-conditioned step calls twice), or None."""
    vals = [v for m in _moes(model) for v in m.aux_values]
    return torch.stack(vals).mean() if vals else None
