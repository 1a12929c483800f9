"""Token merging (ToMe) for the DiT: training-free token reduction.

Counterpart of ``eo_diffusion_tpu/ops/tome.py`` (Bolya & Hoffman,
arXiv:2303.17604; ToMe arXiv:2210.09461). Bipartite soft matching, per
sample:

* the token grid splits into **dst** (the top-left token of every ``sy x
  sx`` cell) and **src** (the rest): :func:`tome_partition`;
* every src token keeps its most cosine-similar dst token (the metric in
  float32, normalised with ``max(|m|, 1e-6)``; ``argmax``'s first maximum);
* the ``r`` src tokens of highest score (a stable descending sort, ties in
  token order) are merged into their dst as the plain mean of the dst row
  and its sources, formed in float32; the rest pass through;
* ``unmerge`` gives every merged src its dst's row back.

The merge count ``r`` is a Python int (:func:`aligned_merge_count`), so the
merged token count ``T - r`` is fixed for a configuration: at ``dit256``
(T 1024) a ratio of 0.375 gives 640 tokens, which the fused-qkv attention
kernel takes like any other aligned count. The assignment is discrete and
computed once a block, without a gradient, into index tensors on the
device (no host copy, no boolean mask: the host never waits); ``merge`` is
two gathers, one ``scatter_add`` and a concat, ``unmerge`` one gather, and
both carry gradients.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["tome_partition", "aligned_merge_count", "build_merge"]


@functools.lru_cache(maxsize=None)
def tome_partition(grid_h: int, grid_w: int, sx: int = 2, sy: int = 2
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The dst / src token indices of a row-major ``grid_h x grid_w`` grid:
    dst is the top-left token of every ``sy x sx`` cell."""
    ys, xs = np.meshgrid(np.arange(grid_h), np.arange(grid_w), indexing="ij")
    is_dst = ((ys % sy == 0) & (xs % sx == 0)).reshape(-1)
    idx = np.arange(grid_h * grid_w)
    return idx[is_dst], idx[~is_dst]


def aligned_merge_count(tokens: int, n_src: int, ratio: float) -> int:
    """The merge count ``r`` for ``ratio`` of all tokens, rounded so that the
    merged count is a multiple of 8 up to T 1024 and of 512 beyond (the
    fused-qkv attention kernel's aligned blocks); never more than the src
    tokens."""
    r = int(round(tokens * ratio))
    tm = tokens - r
    align = 512 if tm > 1024 else 8
    tm = max(align, int(round(tm / align)) * align)
    r = tokens - min(tm, tokens)
    return max(0, min(r, n_src))


@functools.lru_cache(maxsize=None)
def _partition_on(grid_h: int, grid_w: int, sx: int, sy: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`tome_partition` as index tensors on ``device``, made once: a
    copy from the host in every block would wait for the device's queue.
    Made outside inference mode, so that training may reuse what sampling
    cached."""
    dst, src = tome_partition(grid_h, grid_w, sx, sy)
    with torch.inference_mode(False):
        return torch.as_tensor(dst, device=device), torch.as_tensor(src, device=device)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i]]`` for ``x [B, T, C]`` and ``idx [B, K]``."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def build_merge(metric: torch.Tensor, grid: Tuple[int, int], r: int, sx: int = 2,
                sy: int = 2) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                                      Callable[[torch.Tensor], torch.Tensor]]:
    """``(merge, unmerge)`` from a similarity metric ``[B, T, D]``.

    ``merge(x)``: ``[B, T, C] -> [B, T - r, C]`` laid out ``[unmerged src
    (Ns - r) | dst (Nd)]``; ``unmerge(a)``: ``[B, T - r, C] -> [B, T, C]``.
    Both use the same assignment, so the pair of calls inside one block
    agrees; ``r == 0`` is an exact permutation round trip."""
    dst_idx, src_idx = _partition_on(grid[0], grid[1], sx, sy, metric.device)
    n_dst, n_src = len(dst_idx), len(src_idx)
    assert 0 <= r <= n_src, (r, n_src)
    b, n_kept = metric.shape[0], n_src - r
    with torch.no_grad():
        m = metric.detach().float()
        m = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True).clamp_min(1e-6)
        sim = m.index_select(1, src_idx) @ m.index_select(1, dst_idx).transpose(1, 2)
        best_score = sim.amax(dim=-1)  # [B, Ns] against [B, Ns, Nd]
        best_dst = sim.argmax(dim=-1)  # the first maximum, as jnp.argmax
        # descending score, ties in token order (jnp.argsort of -score is stable)
        order = torch.argsort(-best_score, dim=-1, stable=True)
        merged_pos, kept_pos = order[:, :r], order[:, r:]
        merged_dst = torch.gather(best_dst, 1, merged_pos)  # [B, r]
        tokens = src_idx.expand(b, n_src)
        kept_tok, merged_tok = tokens.gather(1, kept_pos), tokens.gather(1, merged_pos)
        # 1 + the sources merged into each dst row
        denom = torch.ones(b, n_dst, device=metric.device).scatter_add_(
            1, merged_dst, torch.ones(b, r, device=metric.device))
        # where each of the T tokens reads its row of the merged layout: a kept
        # src its own, a dst and the sources merged into it the dst's
        rows = torch.arange(n_kept + n_dst, device=metric.device).expand(b, -1)
        at = torch.empty(b, n_dst + n_src, dtype=torch.long, device=metric.device)
        at.scatter_(1, dst_idx.expand(b, n_dst), rows[:, n_kept:])
        at.scatter_(1, kept_tok, rows[:, :n_kept])
        at.scatter_(1, merged_tok, merged_dst + n_kept)

    def merge(x: torch.Tensor) -> torch.Tensor:
        x_dst = x.index_select(1, dst_idx)
        if r:
            sums = x_dst.float().scatter_add(1, merged_dst[..., None].expand(-1, -1, x.shape[-1]),
                                             _take(x, merged_tok).float())
            x_dst = (sums / denom[..., None]).to(x.dtype)
        return torch.cat([_take(x, kept_tok), x_dst], dim=1)

    def unmerge(a: torch.Tensor) -> torch.Tensor:
        return _take(a, at)

    return merge, unmerge
