"""Tiled (fold/unfold) DDIM, flow and bridge sampling for EO scenes larger
than the training patch.

Counterpart of ``eo_diffusion_tpu/diffusion/tiled.py``, a re-design of the
CompVis LatentDiffusion sliding-window ``apply_model`` (reference
``diffusion/ddpm.py:727-777, 1020-1121``): the denoiser trained on ``tile`` x
``tile`` patches runs over an overlapping tile grid of a larger scene, and
the per-tile predictions are blended with smooth border-distance weights
before every reverse step, so the full-scene trajectory stays coherent
across seams. :func:`tiled_flow_sample`
stitches a rectified-flow model's velocities the same way and integrates them
with Euler or Heun steps, and :func:`tiled_bridge_sample` a Brownian-bridge
model's residuals, walking the bridge posterior from the source scene.

The tile grid is one flat index of the scene's pixels: :func:`unfold` is
one gather along it and :func:`fold` one scatter-add (``index_add_``), each
a single pass whatever the number of tiles. On the card ``index_add_``
adds with atomics, so where tiles overlap the order of the (at most four,
at overlap 0.5) f32 terms of a pixel may change from run to run. The
reverse loop is a Python loop, x carried in float32, the model input cast
to ``dtype``, like the port's ``ddim_sample``.

Classifier-free guidance (``guidance_scale``, ``guidance_rescale``,
``uncond``, ``y_uncond``) doubles each chunk of tiles through the shared
guidance points of ``diffusion/gaussian.py``; a stateful denoiser
(``model_state``, DeepCache) keeps one state per chunk of ``tile_batch``
tiles, each chunk a fixed subset of the tiles.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from eo_diffusion_torch.core.schedules import make_ddim_schedule
from eo_diffusion_torch.diffusion.bridge import BrownianBridge
from eo_diffusion_torch.diffusion.flow import FlowMatching, time_grid
from eo_diffusion_torch.diffusion.gaussian import (
    DenoiseFn,
    DiffusionOutput,
    GaussianDiffusion,
    NoiseFn,
    _draw,
    call_guided,
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


def make_tiled_denoiser(model_fn: DenoiseFn, grid: TileGrid, tile: int, n_samples: int,
                        cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                        tile_batch: Optional[int] = None, guidance_scale: float = 1.0,
                        guidance_rescale: float = 0.0, uncond=None, y_uncond=None,
                        model_state=None) -> Callable[..., torch.Tensor]:
    """The per-step tile denoiser of the tiled samplers (JAX
    ``make_tiled_denoiser``).

    Returns ``denoise_tiles(x_tiles [N, nT, t, t, C], t, i=0) -> [N, nT, t,
    t, C']``, which runs ``model_fn(x, t, cond, y)`` over the flat batch of
    ``N*nT`` tiles, or over chunks of ``tile_batch`` tiles to bound memory.
    The full-scene ``cond`` and ``uncond`` are unfolded once here, ``y`` and
    ``y_uncond`` repeated per tile. ``t`` is the DDPM chain's integer step
    (a ``torch.long`` batch) or the flow ODE's 0-dim time tensor (expanded as
    it is). CFG doubles each chunk and combines it at ``guidance_scale``
    (the tiled samplers take no interval). With ``model_state``,
    ``model_fn(x, t, cond, y, state, i) -> (out, state)`` and the state is
    stacked once per chunk (one copy for each, carried across the steps),
    ``i`` the sampler's step.
    """
    unfold_flat = lambda a: unfold(a, grid).flatten(0, 1)
    use_cfg = uncond is not None and guidance_scale != 1.0
    cond_flat = unfold_flat(cond) if cond is not None else None
    uncond_flat = unfold_flat(uncond) if use_cfg else None
    y_flat = y.repeat_interleave(grid.num_tiles, 0) if y is not None else None
    yu_flat = (y_uncond.repeat_interleave(grid.num_tiles, 0)
               if y_uncond is not None and guidance_scale != 1.0 else None)
    n_flat = n_samples * grid.num_tiles
    step = n_flat if tile_batch is None else tile_batch
    n_chunks = -(-n_flat // step)
    states = None if model_state is None else [model_state] * n_chunks
    part = lambda a, s: None if a is None else a[s:s + step]

    def denoise_tiles(x_tiles: torch.Tensor, t_scalar, i: int = 0) -> torch.Tensor:
        n, nt = x_tiles.shape[:2]
        flat = x_tiles.reshape(n * nt, tile, tile, x_tiles.shape[-1])
        if torch.is_tensor(t_scalar):
            ts = t_scalar.to(flat.device).expand(n * nt)
        else:
            ts = torch.full((n * nt,), int(t_scalar), dtype=torch.long, device=flat.device)
        outs = []
        for c, s in enumerate(range(0, n * nt, step)):
            out, st = call_guided(
                model_fn, flat[s:s + step], ts[s:s + step], part(cond_flat, s),
                part(y_flat, s), uncond=part(uncond_flat, s), y_uncond=part(yu_flat, s),
                guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
                state=None if states is None else states[c], i=i)
            if states is not None:
                states[c] = st
            outs.append(out)
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
    ``guidance_scale`` with a full-scene ``uncond`` or the null labels
    ``y_uncond``, and ``model_state`` (DeepCache: one state per chunk of
    ``tile_batch`` tiles), as in :func:`make_tiled_denoiser`. A
    self-conditioned process is refused: the per-tile x0 carry is not
    threaded through the stitching.
    """
    assert not diffusion.self_condition, "tiled sampling does not support self_condition"
    tile = diffusion.image_size
    grid = make_tile_grid(height, width, tile, overlap)
    dd = make_ddim_schedule(diffusion.schedule, num_steps, eta)
    shape = (n_samples, height, width, diffusion.in_channels)
    x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
         else torch.randn(shape, generator=generator, device=device))
    alphas_prev = torch.as_tensor(dd.alphas_prev, device=device)
    sigmas = torch.as_tensor(dd.sigmas, device=device)
    denoise_tiles = make_tiled_denoiser(
        model_fn, grid, tile, n_samples, cond=cond, y=y, tile_batch=tile_batch,
        guidance_scale=guidance_scale, guidance_rescale=guidance_rescale, uncond=uncond,
        y_uncond=y_uncond, model_state=model_state)
    if mask is not None:
        assert x0 is not None, "tiled inpainting requires x0"
        mask, x0 = mask.float(), x0.float()
    for i, idx in enumerate(range(dd.num_steps - 1, -1, -1)):
        t_scalar = int(dd.timesteps[idx])
        t = torch.full((n_samples,), t_scalar, dtype=torch.long, device=device)
        if mask is not None:
            noise = _draw(noise_fn, generator, i, "mask", shape, device)
            x = diffusion.q_sample(x0, t, noise) * mask + (1.0 - mask) * x
        raw = fold(denoise_tiles(unfold(x.to(dtype), grid), t_scalar, i), grid)
        e_t, pred_x0 = diffusion._to_eps_x0(raw, x.float(), t)
        a_prev, sigma_t = alphas_prev[idx], sigmas[idx]
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=0.0)) * e_t
        x = torch.sqrt(a_prev) * pred_x0 + dir_xt
        if eta != 0.0:
            x = x + sigma_t * _draw(noise_fn, generator, i, "eta", shape, device)
    return DiffusionOutput(x=x)


def tiled_flow_sample(flow: FlowMatching, model_fn: DenoiseFn, n_samples: int, height: int,
                      width: int, *, device, generator: Optional[torch.Generator] = None,
                      num_steps: int = 16, method: str = "heun", overlap: float = 0.5,
                      tile_batch: Optional[int] = None, cond: Optional[torch.Tensor] = None,
                      y: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                      x0: Optional[torch.Tensor] = None, x_T: Optional[torch.Tensor] = None,
                      dtype: torch.dtype = torch.float32, noise_fn: Optional[NoiseFn] = None,
                      guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
                      uncond=None, y_uncond=None, model_state=None) -> DiffusionOutput:
    """Rectified-flow sampling of a ``height`` x ``width`` scene with a model
    trained on ``flow.image_size`` tiles (JAX ``tiled_flow_sample``,
    ``diffusion/tiled.py:313-395``).

    The tiles' velocities are stitched like :func:`tiled_ddim_sample`'s
    predictions (velocities are linear, so the weighted mean of the tiles'
    is the stitched field's) and integrated from t = 1 to 0 over
    ``linspace(1, 0, num_steps + 1)``: Euler, or Heun with two stitched
    evaluations a step except the last, which is an Euler step. The model
    sees ``t * flow.time_scale``. ``mask``/``x0``: before each step the
    known region is put back on the straight path at the current time with a
    fresh eps (``noise_fn(i, "mask")``), and x0 is pasted in at the end.
    ``x_T`` is the starting noise; x is carried in float32 and cast to
    ``dtype`` for the model. CFG and ``model_state`` as in
    :func:`tiled_ddim_sample`; both Heun evaluations of step ``i`` pass
    ``i``.
    """
    if method not in ("euler", "heun"):
        raise ValueError(f"method must be 'euler' or 'heun', got {method!r}")
    if mask is not None:
        assert x0 is not None, "flow inpainting requires x0 (known image)"
        mask, x0 = mask.float(), x0.float()
    tile = flow.image_size
    grid = make_tile_grid(height, width, tile, overlap)
    shape = (n_samples, height, width, flow.in_channels)
    x = (x_T.to(device=device, dtype=torch.float32) if x_T is not None
         else torch.randn(shape, generator=generator, device=device))
    denoise_tiles = make_tiled_denoiser(
        model_fn, grid, tile, n_samples, cond=cond, y=y, tile_batch=tile_batch,
        guidance_scale=guidance_scale, guidance_rescale=guidance_rescale, uncond=uncond,
        y_uncond=y_uncond, model_state=model_state)
    ts = torch.as_tensor(time_grid(1.0, num_steps + 1), device=device)

    def velocity(xx: torch.Tensor, t: torch.Tensor, i: int) -> torch.Tensor:
        return fold(denoise_tiles(unfold(xx.to(dtype), grid), t * flow.time_scale, i), grid)

    for i in range(num_steps):
        t_i, t_next = ts[i], ts[i + 1]
        dt = t_next - t_i  # negative: toward the data
        if mask is not None:
            eps = _draw(noise_fn, generator, i, "mask", shape, device)
            x = mask * ((1.0 - t_i) * x0 + t_i * eps) + (1.0 - mask) * x
        v = velocity(x, t_i, i)
        if method == "heun" and i < num_steps - 1:
            v = 0.5 * (v + velocity(x + dt * v, t_next, i))
        x = x + dt * v
    if mask is not None:
        x = mask * x0 + (1.0 - mask) * x
    return DiffusionOutput(x=x)


def tiled_bridge_sample(bridge: BrownianBridge, model_fn: DenoiseFn, n_samples: int,
                        height: int, width: int, *, device,
                        generator: Optional[torch.Generator] = None, num_steps: int = 25,
                        overlap: float = 0.5, tile_batch: Optional[int] = None,
                        cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                        eta: float = 0.0, clip: bool = True,
                        dtype: torch.dtype = torch.float32, noise_fn: Optional[NoiseFn] = None,
                        model_state=None) -> DiffusionOutput:
    """Paired translation of a ``height`` x ``width`` scene on the Brownian
    bridge with a model trained on ``bridge.image_size`` tiles (JAX
    ``tiled_bridge_sample``, ``diffusion/tiled.py:398-464``).

    ``cond`` is the required full-scene source (the cloudy scene): x starts
    at it, each tile carries its slice of it into the model (the concat
    cond of :func:`make_tiled_denoiser`), and the tiles' residual
    predictions are stitched like :func:`tiled_flow_sample`'s velocities (a
    residual is linear, so the weighted mean of the tiles' is the stitched
    field's). The posterior step then runs once on the whole scene, with the
    grid and the algebra of ``BrownianBridge.strided_grid`` and
    ``posterior_step``. ``clip`` clamps x0_hat to [-1, 1]; ``eta`` scales
    the posterior noise (``noise_fn(i, "eta")``; nothing is drawn at 0).
    ``model_state`` as in :func:`tiled_ddim_sample`.
    """
    assert cond is not None, "bridge sampling requires the source scene (cond)"
    tile = bridge.image_size
    grid = make_tile_grid(height, width, tile, overlap)
    shape = (n_samples, height, width, bridge.in_channels)
    num_steps, t_seq, m_seq, d_seq = bridge.strided_grid(num_steps)
    yf = cond.to(device=device, dtype=torch.float32).expand(shape)
    denoise_tiles = make_tiled_denoiser(
        model_fn, grid, tile, n_samples, cond=yf if bridge.cond_type == "concat" else None,
        y=y, tile_batch=tile_batch, model_state=model_state)
    x = yf.clone()  # x_{T-1} = y exactly; a copy, never a view of cond
    for i in range(num_steps):
        pred = fold(denoise_tiles(unfold(x.to(dtype), grid), int(t_seq[i]), i), grid)
        x0_hat = x - pred
        if clip:
            x0_hat = torch.clamp(x0_hat, -1.0, 1.0)
        mean, var = bridge.posterior_step(x, x0_hat, yf, m_seq[i], m_seq[i + 1], d_seq[i],
                                          d_seq[i + 1])
        if eta != 0.0:
            noise = _draw(noise_fn, generator, i, "eta", shape, device)
            mean = mean + float(np.float32(eta) * np.sqrt(var)) * noise
        x = mean
    return DiffusionOutput(x=x)
