"""First-stage autoencoder training for latent diffusion, in PyTorch.

Counterpart of ``eo_diffusion_tpu/train/ae_trainer.py``. The reference's
first stage arrives pre-trained from CompVis (``diffusion/ddpm.py:628-645``);
with no pretrained VAE here, the latent presets train their own small
:class:`~eo_diffusion_torch.models.autoencoder.ConvAutoencoder` on the
target dataset before the denoiser (``cli/train.py --preset latent256-cr``).

Loss = MSE reconstruction + ``latent_reg`` * mean(z^2), the deterministic
stand-in for the CompVis KL term: it keeps the latents bounded so the
process's fixed noise schedule stays calibrated. The optimizer is Adam
(b1 0.9, b2 0.999, eps 1e-8, no weight decay), optax's ``adam`` in the JAX
package. After training ``scale_factor = 1 / std(z)`` over the first batch
with the final weights, the CompVis first-batch rescaling (ddpm.py:677-692),
so latents enter the diffusion with unit variance.

A trained first stage is saved as ``params.pt`` (the module's state dict)
beside the JAX package's ``ae_meta.json`` sidecar (the
:class:`AutoencoderConfig` fields and ``scale_factor``), so the sampling CLI
rebuilds it without the training-side preset.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from eo_diffusion_torch.diffusion.latent import LatentDiffusion
from eo_diffusion_torch.models.autoencoder import AutoencoderConfig, ConvAutoencoder

__all__ = ["train_autoencoder", "save_ae", "load_ae", "make_codec", "latent_process",
           "ae_exists"]

_META = "ae_meta.json"
_PARAMS = "params.pt"


def _cycle(src, cap):
    """Yield from ``src`` repeatedly.

    Re-iterable sources (lists, loader views like ``cli.train``'s
    ``_ImageBatches``) are re-iterated each epoch: no host-memory cache and a
    fresh shuffle each epoch. Only a one-shot generator (``iter(src) is
    src``) is replayed from a cache of its first ``cap`` items (the draws
    needed)."""
    it0 = iter(src)
    if iter(src) is it0:  # one-shot generator: iter() returns itself
        seen = []
        for item in it0:
            if len(seen) < cap:
                seen.append(item)
            yield item
        assert seen, "train_autoencoder got an empty batches iterable"
        while True:
            for item in seen:
                yield item
    else:
        epochs = 0
        while True:
            got = False
            for item in it0 if epochs == 0 else iter(src):
                got = True
                yield item
            if not got:
                raise RuntimeError(
                    "train_autoencoder: batches source yielded nothing"
                    + (" on re-iteration (a re-iterable wrapper over a "
                       "spent iterator?)" if epochs else ""))
            epochs += 1


def ae_loss(model: ConvAutoencoder, x: torch.Tensor, latent_reg: float = 1e-4):
    """``(loss, recon_mse)``: the reconstruction MSE plus ``latent_reg`` *
    mean(z^2), float32 scalars."""
    z = model.encode(x)
    rec_l = ((model.decode(z) - x.float()) ** 2).mean()
    return rec_l + latent_reg * (z.float() ** 2).mean(), rec_l


def train_autoencoder(model: ConvAutoencoder, batches: Iterable, steps: int,
                      lr: float = 2e-3, latent_reg: float = 1e-4, log_every: int = 0,
                      device=None, step_seconds: Optional[List[float]] = None
                      ) -> Tuple[ConvAutoencoder, float, list]:
    """Train the first stage in place; returns ``(model, scale_factor,
    losses)``.

    :param model: the autoencoder with its initial weights (seed torch's
        generator before building it).
    :param batches: iterable of ``[N, H, W, C]`` float arrays or tensors,
        cycled (:func:`_cycle`) when shorter than ``steps``.
    :param latent_reg: weight of the mean(z^2) penalty.
    :param log_every: print and keep the reconstruction MSE every so many steps.
    :param device: where to train (default: the model's device).
    :param step_seconds: a list that gets each step's host seconds, each
        ending in a fetch of the loss.
    """
    device = torch.device(device) if device is not None else next(model.parameters()).device
    model = model.to(device).train()
    as_dev = lambda a: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                       dtype=torch.float32).to(device)
    it = _cycle(batches, steps)
    first = as_dev(next(it))
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses, x = [], first
    for i in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, rec_l = ae_loss(model, x, latent_reg)
        loss.backward()
        opt.step()
        rec_l = rec_l.detach()
        if step_seconds is not None:
            float(rec_l)  # the step really ran
            step_seconds.append(time.perf_counter() - t0)
        if log_every and i % log_every == 0:
            losses.append(float(rec_l))
            print(f"ae step {i}/{steps} recon_mse {losses[-1]:.5f}", flush=True)
        x = as_dev(next(it))

    model.eval()
    with torch.no_grad():
        z = model.encode(first)
        scale = 1.0 / max(float(z.float().std(correction=0)), 1e-6)
    return model, scale, losses


def make_codec(model: ConvAutoencoder):
    """``(encode_fn, decode_fn)`` of a frozen first stage for
    :class:`~eo_diffusion_torch.diffusion.latent.LatentDiffusion`: the model
    in eval mode with its parameters' gradients off."""
    model.requires_grad_(False).eval()
    return model.encode, model.decode


def latent_process(inner, model: ConvAutoencoder, scale_factor: float = 1.0) -> LatentDiffusion:
    """The latent presets' process: ``inner`` (sized to the latent grid)
    behind the frozen first stage ``model``, a concat cond encoded too. A
    "sum" cond is refused: its mask composite is pixel-space."""
    if inner.cond_type == "sum":
        raise ValueError("latent presets do not support RePaint-'sum' conditioning: the mask "
                         "composite is pixel-space; use cond_type='concat' (encoded cond)")
    return LatentDiffusion(inner, *make_codec(model), scale_factor=scale_factor,
                           cond_via_encoder=True)


def save_ae(ae_dir: str, config: AutoencoderConfig, model: ConvAutoencoder,
            scale_factor: float) -> str:
    """Write ``params.pt`` and ``ae_meta.json`` under ``ae_dir``."""
    os.makedirs(ae_dir, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(ae_dir, _PARAMS))
    meta = {k: v for k, v in dataclasses.asdict(config).items() if k != "dtype"}
    meta["scale_factor"] = float(scale_factor)
    with open(os.path.join(ae_dir, _META), "w") as f:
        json.dump(meta, f, indent=2)
    return ae_dir


def load_ae(ae_dir: str, device=None) -> Tuple[ConvAutoencoder, float]:
    """Rebuild ``(model, scale_factor)`` from :func:`save_ae` output, float32,
    on ``device`` (default the CPU)."""
    with open(os.path.join(ae_dir, _META)) as f:
        meta = json.load(f)
    path = os.path.join(ae_dir, _PARAMS)
    if not os.path.isfile(path) and os.path.isdir(os.path.join(ae_dir, "params")):
        raise NotImplementedError(
            f"{ae_dir} holds a first stage saved by the JAX package (orbax params/); "
            "convert it with tools/jax_ckpt_to_torch.py (--preset with the denoiser's "
            "checkpoint), which writes the port's params.pt and ae_meta.json")
    scale = meta.pop("scale_factor")
    model = ConvAutoencoder(AutoencoderConfig(**meta))
    model.load_state_dict(torch.load(path, map_location="cpu"), strict=True)
    return model.to(device or "cpu"), scale


def ae_exists(ae_dir: Optional[str]) -> bool:
    return bool(ae_dir) and os.path.isfile(os.path.join(ae_dir, _META))
