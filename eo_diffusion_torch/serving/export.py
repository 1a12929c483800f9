"""The serving engine's sampler as a self-contained ``torch.export`` artifact
(counterpart of ``eo_diffusion_tpu/serving/export.py``).

The JAX package serializes its engine's one ``lax.scan`` program with
``jax.export``. Here :func:`export_engine` exports
:meth:`SamplerEngine.program <eo_diffusion_torch.serving.engine.SamplerEngine.program>`
with ``torch.export``: the whole trajectory, unrolled (``torch.export`` has
no stable loop construct), guidance, int8 dequantization and all. The
attention and GroupNorm kernels are ``eo::`` custom ops in the graph
(``ops/library.py``), so the artifact launches the same kernels as the
live engine. A deployment host then needs ``torch``, ``numpy``, the op
library and the seeding module: no model code, no sampler, no preset.

Artifact layout (``out_dir/``)::

    sampler.pt2     torch.export.save of the program
    params.npz      flat parameter leaves, key ``p{i:05d}`` in the engine's
                    ``leaves()`` order (int8 leaves stay int8)
    manifest.json   shapes, sampler configuration, provenance

The program's inputs are ``(leaves, x_T, noise, y, cond)``: the leaves as a
flat tuple; the start noise and the ``[k, *grid]`` stack of the sampler's
noises, which :func:`load_model`'s ``generate(seed)`` draws with
``serving/seeding.py`` as the live engine does, so the artifact returns the
live engine's bytes for a seed on the same device; ``y`` and ``cond`` are
tensors where the engine is class- or concat-conditional, else None.

The program is exported under ``torch.no_grad()`` (not ``inference_mode``)
and without ``run_decompositions()``, so its ATen ops are those the live
engine runs. Its size and trace time grow with the sampler's model calls:
:func:`export_engine` refuses a sampler of more than ``MAX_EXPORT_CALLS``
(the 1000-call DDPM chain, ROADMAP queue 1, item 18).

The loader half (:func:`load_model`) imports only torch, numpy, the standard
library, ``ops/library.py`` and ``serving/seeding.py``
(``tests/test_torch_export.py`` checks it in a fresh process).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from eo_diffusion_torch.serving import seeding

__all__ = ["export_engine", "load_model", "MANIFEST_NAME", "MAX_EXPORT_CALLS"]

MANIFEST_NAME = "manifest.json"
_PROGRAM_NAME = "sampler.pt2"
_PARAMS_NAME = "params.npz"
# model calls a trajectory may unroll to: DDIM-250 and every few-step sampler
# export; the DDPM chain (timesteps calls, and a noise input of timesteps
# batches) does not
MAX_EXPORT_CALLS = 250


def _leaf_key(i: int) -> str:
    return f"p{i:05d}"


@contextlib.contextmanager
def _fresh_tables(diffusion):
    """Run with empty coefficient caches (``GaussianDiffusion._tables``) and
    put the old ones back: a table made while the exporter traces holds a
    fake tensor, which must reach neither the live engine nor a later export."""
    owners = [d for d in (diffusion, getattr(diffusion, "diffusion", None))
              if isinstance(getattr(d, "_tables", None), dict)]
    saved = [dict(d._tables) for d in owners]
    for d in owners:
        d._tables.clear()
    try:
        yield
    finally:
        for d, old in zip(owners, saved):
            d._tables.clear()
            d._tables.update(old)


class _Program(torch.nn.Module):
    """The engine's program as a module that owns no parameter: the weights
    are the ``leaves`` input."""

    def __init__(self, engine):
        super().__init__()
        self.__dict__["engine"] = engine  # not a submodule: no weights in the graph

    def forward(self, leaves, x_T, noise, y, cond):
        return self.engine.program(leaves, x_T, noise, y, cond)


def export_engine(engine, out_dir: str, extra_meta: Optional[dict] = None) -> dict:
    """Export a :class:`~eo_diffusion_torch.serving.engine.SamplerEngine`'s
    program and weights into ``out_dir``; returns the manifest (with the
    export's seconds and the artifact's bytes)."""
    from eo_diffusion_torch.nn.primitives import int8_dense_compute

    cfg = engine.cfg
    t0 = time.perf_counter()
    draws, calls = engine.count_draws()
    if calls > MAX_EXPORT_CALLS:
        raise ValueError(
            f"the {cfg.sampler} trajectory makes {calls} model calls a batch; export_engine "
            f"unrolls at most {MAX_EXPORT_CALLS} (ROADMAP queue 1, item 18: a step program "
            "for the long chains)")
    leaves = tuple(engine.leaves())
    x_T, noise = seeding.draws(0, engine.grid, draws, engine.device)
    y0, c0 = engine._inputs(engine._blank_y(), engine._blank_cond())
    dev = (torch.cuda.device(engine.device) if engine.device.type == "cuda"
           else contextlib.nullcontext())
    w8a8 = int8_dense_compute() if cfg.int8_compute else contextlib.nullcontext()
    with dev, w8a8, _fresh_tables(engine.diffusion), torch.no_grad():
        ep = torch.export.export(_Program(engine), (leaves, x_T, noise, y0, c0), strict=False)
    trace_s = time.perf_counter() - t0

    os.makedirs(out_dir, exist_ok=True)
    ep.example_inputs = None  # the weights are params.npz's: not a second copy in the program
    torch.export.save(ep, os.path.join(out_dir, _PROGRAM_NAME))
    np.savez(os.path.join(out_dir, _PARAMS_NAME),
             **{_leaf_key(i): leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)})
    manifest = {
        "format": "eo_diffusion_torch.export/1",
        "torch_version": torch.__version__,
        "device": engine.device.type,
        "n_leaves": len(leaves),
        "param_bytes": int(sum(leaf.numel() * leaf.element_size() for leaf in leaves)),
        "batch_size": cfg.batch_size,
        "image_size": engine.image_size,
        "channels": engine.channels,
        "grid": list(engine.grid),
        "noise_draws": draws,
        "model_calls": calls,
        "num_classes": cfg.num_classes,
        "cond_channels": cfg.cond_channels,
        "sampler": cfg.sampler,
        "steps": cfg.steps,
        "eta": cfg.eta,
        "ddim_spacing": cfg.ddim_spacing,
        "guidance_scale": cfg.guidance_scale,
        "pag_scale": cfg.pag_scale,
        "int8": cfg.int8,
        "int8_compute": cfg.int8_compute,
        "bf16": cfg.bf16,
        "graph_nodes": len(ep.graph.nodes),
        "eo_ops": sorted({str(n.target) for n in ep.graph.nodes
                          if n.op == "call_function" and str(n.target).startswith("eo.")}),
    }
    if extra_meta:
        manifest.update(extra_meta)
    manifest["export_seconds"] = time.perf_counter() - t0
    manifest["trace_seconds"] = trace_s
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    manifest["artifact_bytes"] = sum(os.path.getsize(os.path.join(out_dir, n))
                                     for n in (_PROGRAM_NAME, _PARAMS_NAME, MANIFEST_NAME))
    return manifest


def load_model(out_dir: str, device: Optional[str] = None) -> tuple:
    """Load an exported artifact; returns ``(generate, manifest)``.

    ``generate(seed, y=None, cond=None) -> np.ndarray [B, H, W, C]`` runs one
    device batch through the loaded program from the seed's draws. ``y`` is
    ``[B]`` int labels (class-conditional artifacts only), ``cond`` ``[B, H,
    W, Cc]`` (concat-conditional only); an omitted one takes the engine's
    blank value. ``device`` defaults to the one the artifact was exported
    on (its graph carries that device). The manifest also gets
    ``load_seconds``.
    """
    from eo_diffusion_torch.ops import library  # noqa: F401  (registers the eo:: ops)

    t0 = time.perf_counter()
    with open(os.path.join(out_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    dev = torch.device(device or manifest["device"])
    # as the port's CLIs run: float32 products and convolutions without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    program = torch.export.load(os.path.join(out_dir, _PROGRAM_NAME)).module()
    z = np.load(os.path.join(out_dir, _PARAMS_NAME))
    leaves = tuple(torch.from_numpy(z[_leaf_key(i)]).to(dev)
                   for i in range(manifest["n_leaves"]))
    B, H = manifest["batch_size"], manifest["image_size"]
    nc, cc = manifest["num_classes"], manifest["cond_channels"]
    grid, draws = tuple(manifest["grid"]), manifest["noise_draws"]

    def generate(seed: int, y=None, cond=None) -> np.ndarray:
        if nc:
            y = np.zeros((B,), np.int64) if y is None else np.asarray(y, np.int64)
            assert y.shape == (B,) and 0 <= int(y.min()) and int(y.max()) < nc, (
                f"y must be [{B}] labels in [0, {nc}), got shape {y.shape}")
            y = torch.as_tensor(y, device=dev)
        else:
            assert y is None, "artifact is not class-conditional"
        if cc:
            cond = (np.zeros((B, H, H, cc), np.float32) if cond is None
                    else np.asarray(cond, np.float32))
            assert cond.shape == (B, H, H, cc), (cond.shape, (B, H, H, cc))
            cond = torch.as_tensor(cond, device=dev)
        else:
            assert cond is None, "artifact is not concat-conditional"
        x_T, noise = seeding.draws(seed, grid, draws, dev)
        with torch.no_grad():
            return program(leaves, x_T, noise, y, cond).cpu().numpy()

    manifest["load_seconds"] = time.perf_counter() - t0
    return generate, manifest
