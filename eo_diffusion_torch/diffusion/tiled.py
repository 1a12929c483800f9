"""Tiled (fold/unfold) DDIM sampling for EO scenes larger than the training patch.

Counterpart of the DDPM part of ``eo_diffusion_tpu/diffusion/tiled.py``
(l.39-310), a re-design of the CompVis LatentDiffusion sliding-window
``apply_model`` (reference ``diffusion/ddpm.py:727-777, 1020-1121``): the
denoiser trained on ``tile`` x ``tile`` patches runs over an overlapping
tile grid of a larger scene, and the per-tile predictions are blended with
smooth border-distance weights before every reverse step, so the
full-scene trajectory stays coherent across seams.

The tile grid is one flat index of the scene's pixels: :func:`unfold` is
one gather along it and :func:`fold` one scatter-add (``index_add_``), each
a single pass whatever the number of tiles. On the card ``index_add_``
adds with atomics, so where tiles overlap the order of the (at most four,
at overlap 0.5) f32 terms of a pixel may change from run to run. The
reverse loop is a Python loop, x carried in float32, the model input cast
to ``dtype``, like the port's ``ddim_sample``.

Not ported yet, and raising when asked for: classifier-free guidance
(``guidance_scale``, ``guidance_rescale``, ``uncond``, ``y_uncond``) and
stateful denoisers (``model_state``, DeepCache), ROADMAP queue 11;
``tiled_flow_sample`` (queue 10) and ``tiled_bridge_sample`` (queue 11).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from eo_diffusion_torch.core.schedules import make_ddim_schedule
from eo_diffusion_torch.diffusion.gaussian import (
    DenoiseFn,
    DiffusionOutput,
    GaussianDiffusion,
    NoiseFn,
    _draw,
)

__all__ = ["TileGrid", "make_tile_grid", "unfold", "fold", "make_tiled_denoiser",
           "tiled_ddim_sample", "tiled_flow_sample", "tiled_bridge_sample"]


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static tiling plan for an (H, W) scene."""

    height: int
    width: int
    tile: int
    offsets_i: Tuple[int, ...]
    offsets_j: Tuple[int, ...]

    @property
    def num_tiles(self) -> int:
        return len(self.offsets_i) * len(self.offsets_j)


def make_tile_grid(height: int, width: int, tile: int, overlap: float = 0.5) -> TileGrid:
    """Tile offsets at stride (1-overlap)*tile, with the last tile clamped to
    the scene edge (full coverage regardless of divisibility)."""
    assert tile <= height and tile <= width, (tile, height, width)
    stride = max(int(tile * (1.0 - overlap)), 1)

    def offsets(extent):
        offs = list(range(0, extent - tile + 1, stride))
        if offs[-1] != extent - tile:
            offs.append(extent - tile)
        return tuple(offs)

    return TileGrid(height, width, tile, offsets(height), offsets(width))


def _border_weight(tile: int) -> np.ndarray:
    """Smooth per-pixel weight, peaked at the tile centre (the CompVis
    border-distance weighting, ddpm.py:1031-1113, in cosine form)."""
    ramp = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(tile) + 0.5) / tile)
    w = np.outer(ramp, ramp) + 1e-4
    return w.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _plan(grid: TileGrid, device: torch.device):
    """The grid's flat pixel index ``[nT*t*t]`` (tile-major, then row, then
    column; pixel ``i*W + j``), the border weight ``[t*t, 1]`` and the
    blending norm ``[H*W, 1]`` (the weights summed over the tiles in tile
    order, in float32), on ``device``."""
    t = grid.tile
    ar = np.arange(t)
    idx = np.concatenate([((oi + ar)[:, None] * grid.width + oj + ar[None, :]).ravel()
                          for oi in grid.offsets_i for oj in grid.offsets_j])
    w = _border_weight(t).ravel()
    norm = np.zeros(grid.height * grid.width, np.float32)
    for k in range(grid.num_tiles):
        norm[idx[k * t * t:(k + 1) * t * t]] += w
    as_dev = lambda a: torch.as_tensor(a, device=device)
    return as_dev(idx), as_dev(w[:, None]), as_dev(norm[:, None])


def unfold(x: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """``[N, H, W, C]`` -> ``[N, nT, tile, tile, C]``, one gather."""
    n, c, t = x.shape[0], x.shape[-1], grid.tile
    idx, _, _ = _plan(grid, x.device)
    return x.reshape(n, -1, c).index_select(1, idx).reshape(n, grid.num_tiles, t, t, c)


def fold(tiles: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """``[N, nT, tile, tile, C]`` -> ``[N, H, W, C]`` float32, the tiles
    blended with the normalized border weights: one scatter-add."""
    n, nt, t, _, c = tiles.shape
    idx, w, norm = _plan(grid, tiles.device)
    src = (tiles.float().reshape(n, nt, t * t, c) * w).reshape(n, nt * t * t, c)
    out = torch.zeros((n, grid.height * grid.width, c), dtype=torch.float32,
                      device=tiles.device)
    out.index_add_(1, idx, src)
    return (out / norm).reshape(n, grid.height, grid.width, c)


def _unported(guidance_scale=1.0, guidance_rescale=0.0, uncond=None, y_uncond=None,
              model_state=None) -> None:
    if guidance_scale != 1.0 or guidance_rescale != 0.0 or uncond is not None \
            or y_uncond is not None:
        raise NotImplementedError("classifier-free guidance (guidance_scale, "
                                  "guidance_rescale, uncond, y_uncond): not ported yet "
                                  "(ROADMAP queue 11)")
    if model_state is not None:
        raise NotImplementedError("model_state (DeepCache): not ported yet (ROADMAP queue 11)")


def make_tiled_denoiser(model_fn: DenoiseFn, grid: TileGrid, tile: int, n_samples: int,
                        cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                        tile_batch: Optional[int] = None, guidance_scale: float = 1.0,
                        guidance_rescale: float = 0.0, uncond=None, y_uncond=None,
                        model_state=None) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """The per-step tile denoiser of the tiled samplers.

    Returns ``denoise_tiles(x_tiles [N, nT, t, t, C], t) -> [N, nT, t, t,
    C']``, which runs ``model_fn(x, t, cond, y)`` over the flat batch of
    ``N*nT`` tiles, or over chunks of ``tile_batch`` tiles to bound memory.
    The full-scene ``cond`` is unfolded once here, ``y`` repeated per tile.
    """
    _unported(guidance_scale, guidance_rescale, uncond, y_uncond, model_state)
    cond_flat = unfold(cond, grid).flatten(0, 1) if cond is not None else None
    y_flat = y.repeat_interleave(grid.num_tiles, 0) if y is not None else None
    n_flat = n_samples * grid.num_tiles
    step = n_flat if tile_batch is None else tile_batch
    part = lambda a, s: None if a is None else a[s:s + step]

    def denoise_tiles(x_tiles: torch.Tensor, t_scalar: int) -> torch.Tensor:
        n, nt = x_tiles.shape[:2]
        flat = x_tiles.reshape(n * nt, tile, tile, x_tiles.shape[-1])
        ts = torch.full((n * nt,), int(t_scalar), dtype=torch.long, device=flat.device)
        outs = [model_fn(flat[s:s + step], ts[s:s + step], part(cond_flat, s), part(y_flat, s))
                for s in range(0, n * nt, step)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        return out.reshape(n, nt, tile, tile, out.shape[-1])

    return denoise_tiles


def tiled_ddim_sample(diffusion: GaussianDiffusion, model_fn: DenoiseFn, n_samples: int,
                      height: int, width: int, *, device,
                      generator: Optional[torch.Generator] = None, num_steps: int = 50,
                      eta: float = 0.0, overlap: float = 0.5, tile_batch: Optional[int] = None,
                      cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                      x_T: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
                      noise_fn: Optional[NoiseFn] = None, model_state=None,
                      guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
                      uncond=None, y_uncond=None) -> DiffusionOutput:
    """DDIM sampling of a ``height`` x ``width`` scene with a denoiser trained
    on ``diffusion.image_size`` tiles.

    ``cond``, ``mask`` and ``x0`` are full-scene ``[N, H, W, C]`` tensors;
    ``cond`` is unfolded alongside x, so channel-concat conditioning works
    per tile; the RePaint ``mask`` composites the re-noised ``x0`` on the
    full scene before each step (like ddim.py:145-148). x is carried in
    float32 and cast to ``dtype`` for the model. Draws come from
    ``generator``; ``x_T`` is the starting noise and ``noise_fn(i, "mask" |
    "eta")`` step ``i``'s draws, as in ``GaussianDiffusion.ddim_sample``.
    """
    _unported(guidance_scale, guidance_rescale, uncond, y_uncond, model_state)
    tile = diffusion.image_size
    grid = make_tile_grid(height, width, tile, overlap)
    dd = make_ddim_schedule(diffusion.schedule, num_steps, eta)
    shape = (n_samples, height, width, diffusion.in_channels)
    x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
         else torch.randn(shape, generator=generator, device=device))
    alphas_prev = torch.as_tensor(dd.alphas_prev, device=device)
    sigmas = torch.as_tensor(dd.sigmas, device=device)
    denoise_tiles = make_tiled_denoiser(model_fn, grid, tile, n_samples, cond=cond, y=y,
                                        tile_batch=tile_batch)
    if mask is not None:
        assert x0 is not None, "tiled inpainting requires x0"
        mask, x0 = mask.float(), x0.float()
    for i, idx in enumerate(range(dd.num_steps - 1, -1, -1)):
        t_scalar = int(dd.timesteps[idx])
        t = torch.full((n_samples,), t_scalar, dtype=torch.long, device=device)
        if mask is not None:
            noise = _draw(noise_fn, generator, i, "mask", shape, device)
            x = diffusion.q_sample(x0, t, noise) * mask + (1.0 - mask) * x
        raw = fold(denoise_tiles(unfold(x.to(dtype), grid), t_scalar), grid)
        e_t, pred_x0 = diffusion._to_eps_x0(raw, x.float(), t)
        a_prev, sigma_t = alphas_prev[idx], sigmas[idx]
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=0.0)) * e_t
        x = torch.sqrt(a_prev) * pred_x0 + dir_xt
        if eta != 0.0:
            x = x + sigma_t * _draw(noise_fn, generator, i, "eta", shape, device)
    return DiffusionOutput(x=x)


def tiled_flow_sample(*args, **kwargs):
    """Tiled sampling of a flow-matching model: not ported yet."""
    raise NotImplementedError("tiled_flow_sample: not ported yet (ROADMAP queue 10)")


def tiled_bridge_sample(*args, **kwargs):
    """Tiled sampling of a diffusion bridge: not ported yet."""
    raise NotImplementedError("tiled_bridge_sample: not ported yet (ROADMAP queue 11)")
