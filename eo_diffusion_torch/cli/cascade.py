"""Cascaded generation in the port: a base model samples low-res, an SR
stage upsamples (counterpart of ``eo_diffusion_tpu/cli/cascade.py``).

``python -m eo_diffusion_torch.cli.cascade --base_preset tiny --base_ckpt
logs/base/best --sr_preset tiny-sr --sr_ckpt logs/sr/best --n 16 --outdir
results/cascade``

Any ``sr_factor`` preset (trained by ``cli.train`` on the conditioning
derived from the image, ``data.transforms.sr_cond``) composes behind any
unconditional pixel-space base preset whose ``image_size * sr_factor``
matches: the base samples (DDIM for a DDPM preset, the process's own
``.sample`` for a flow or EDM preset), the samples are upsampled by
``sr_factor`` (nearest), and the SR stage samples DDIM with that as its
concat cond. The JAX package jits the chain into one program; the port runs
it eagerly, a chunk of ``--batch_size`` at a time (:func:`cascade`, which
also takes both stages' start noise).

``cascade_rmse`` is the self-consistency check: the SR output average-pooled
back to the base grid against the base sample. The run writes three grids
(``base.png``, ``base_upsampled.png``, ``sr.png``), ``sr_samples.npy`` and
``cascade_metrics.json`` under ``--outdir``. Checkpoints are the port's
``cli.train`` files (EMA weights unless ``--use_raw_params``). Runs on the
GPU (``--device cuda``, the default) and exits non-zero when there is none;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from eo_diffusion_torch.cli.common import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Cascaded base->SR sampling (PyTorch/CUDA)")
    p.add_argument("--base_preset", type=str, default="synthetic64")
    p.add_argument("--base_ckpt", type=str, required=True)
    p.add_argument("--sr_preset", type=str, default="sr64-256")
    p.add_argument("--sr_ckpt", type=str, required=True)
    p.add_argument("--n", type=int, default=16, help="total samples")
    p.add_argument("--batch_size", type=int, default=None,
                   help="batch per chunk (default: the SR preset's)")
    p.add_argument("--base_steps", type=int, default=50,
                   help="base sampler steps (DDIM for ddpm presets, ODE steps for flow/edm "
                        "presets)")
    p.add_argument("--sr_steps", type=int, default=50, help="SR-stage DDIM steps")
    p.add_argument("--eta", type=float, default=0.0, help="DDIM eta (both)")
    p.add_argument("--ddim_clip", action="store_true",
                   help="clamp pred_x0 in the DDIM steps of both stages (stabilizes weak/early "
                        "checkpoints)")
    p.add_argument("--outdir", type=str, default="results/cascade")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_bf16", action="store_true")
    p.add_argument("--use_raw_params", action="store_true",
                   help="sample from raw params instead of EMA")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; never falls back silently")
    return p.parse_args(argv)


def check_stages(base, sr) -> None:
    """The JAX CLI's checks (``cli/cascade.py:91-107``) on the two presets."""
    assert sr.sr_factor > 0, (
        f"--sr_preset must be an SR stage (sr_factor > 0); {sr.name} is not (see presets "
        f"'sr64-256' / 'tiny-sr')")
    assert sr.process == "ddpm", (
        f"the SR stage samples with DDIM; preset {sr.name} trains {sr.process}")
    assert not base.is_latent and not sr.is_latent, (
        "cascade chains pixel-space stages (a latent base would decode to the same pixel grid "
        "the SR stage expects — train a pixel base)")
    low = sr.image_size // sr.sr_factor
    assert base.image_size == low, (
        f"grid mismatch: base {base.name} samples {base.image_size}px but SR {sr.name} "
        f"upsamples from {low}px ({sr.image_size}/{sr.sr_factor})")
    assert base.cond_type is None, (
        f"the cascade base must be unconditional; {base.name} has "
        f"cond_type={base.cond_type!r}")


def load_stage(preset, ckpt, bf16, use_raw, device, cond_channels=0):
    """A stage's model from a port checkpoint (EMA weights unless
    ``use_raw``), on ``device``, in eval mode, frozen."""
    from eo_diffusion_torch.cli.presets import build_denoiser
    from eo_diffusion_torch.weights import load_reference_checkpoint

    mcfg = preset.model_config(bf16=bf16, cond_channels=cond_channels)
    model = build_denoiser(mcfg)
    model.load_state_dict(load_reference_checkpoint(ckpt, mcfg, use_ema=not use_raw),
                          strict=True)
    return model.to(device).eval().requires_grad_(False)


@torch.inference_mode()
def cascade(base_preset, base_diff, base_model, sr_diff, sr_model, factor, n, *, device,
            generator=None, base_steps=50, sr_steps=50, eta=0.0, clip=False,
            base_x_T=None, sr_x_T=None):
    """One chunk of ``n``: the base sampler, the nearest upsample by
    ``factor``, the SR stage's DDIM with it as concat cond. Returns ``(base
    samples, SR samples, cascade_rmse)``, samples ``[n, H, W, C]`` float32;
    ``base_x_T`` / ``sr_x_T`` fix the stages' start noise (else drawn from
    ``generator``)."""
    base_fn = lambda x, t, c, y: base_model(x, t, cond=c, y=y)
    sr_fn = lambda x, t, c, y: sr_model(x, t, cond=c, y=y)
    if base_preset.process in ("flow", "edm"):
        xb = base_diff.sample(base_fn, n, device=device, generator=generator,
                              num_steps=base_steps, x_T=base_x_T).x
    else:
        xb = base_diff.ddim_sample(base_fn, n, device=device, generator=generator,
                                   num_steps=base_steps, eta=eta, clip=clip, x_T=base_x_T).x
    cond = xb.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
    xs = sr_diff.ddim_sample(sr_fn, n, device=device, generator=generator,
                             num_steps=sr_steps, eta=eta, clip=clip, cond=cond, x_T=sr_x_T).x
    # self-consistency: the SR output average-pooled back to the base grid
    b, h, w, c = xs.shape
    pooled = xs.reshape(b, h // factor, factor, w // factor, factor, c).mean(dim=(2, 4))
    rmse = torch.sqrt(torch.mean((pooled - xb) ** 2))
    return xb.float(), xs.float(), float(rmse)


def main(args):
    """Sample ``args.n`` cascades; returns the metrics written to
    ``cascade_metrics.json`` plus the seconds of every chunk and the SR
    samples."""
    from eo_diffusion_torch.cli.presets import build_process, get_preset
    from eo_diffusion_torch.utils.images import save_image_grid

    device = resolve_device(args.device, "eo_diffusion_torch.cli.cascade")
    base = get_preset(args.base_preset)
    sr = get_preset(args.sr_preset)
    check_stages(base, sr)
    bf16 = not args.no_bf16
    bsz = args.batch_size or sr.batch_size
    base_model = load_stage(base, args.base_ckpt, bf16, args.use_raw_params, device)
    sr_model = load_stage(sr, args.sr_ckpt, bf16, args.use_raw_params, device,
                          cond_channels=sr.in_channels)
    print(f"cascade: {base.name} ({base.image_size}px, {base.process}) -> {sr.name} "
          f"({sr.image_size}px, x{sr.sr_factor})")
    base_diff = build_process(base, base.timesteps, base.image_size, cond_type=None)
    sr_diff = build_process(sr, sr.timesteps, sr.image_size, cond_type="concat")
    f = sr.sr_factor
    gen = torch.Generator(device=device).manual_seed(args.seed)
    os.makedirs(args.outdir, exist_ok=True)
    base_all, sr_all, rmses, chunk_seconds = [], [], [], []
    t0 = time.time()
    for i in range(-(-args.n // bsz)):
        tc = time.perf_counter()
        xb, xs, rmse = cascade(base, base_diff, base_model, sr_diff, sr_model, f, bsz,
                               device=device, generator=gen, base_steps=args.base_steps,
                               sr_steps=args.sr_steps, eta=args.eta, clip=args.ddim_clip)
        base_all.append(xb.cpu().numpy())  # waits for the device
        sr_all.append(xs.cpu().numpy())
        chunk_seconds.append(time.perf_counter() - tc)
        rmses.append(rmse)
        print(f"chunk {i}: {bsz} samples, cascade_rmse={rmse:.4f}")
    wall = time.time() - t0
    base_np = np.concatenate(base_all)[: args.n]
    sr_np = np.concatenate(sr_all)[: args.n]
    assert np.isfinite(sr_np).all(), "non-finite SR samples"

    # grids: base / its nearest upsample (the SR cond) / the SR output
    view = (-1.0, 1.0)
    save_image_grid(base_np, os.path.join(args.outdir, "base.png"), data_range=view)
    up = np.repeat(np.repeat(base_np, f, axis=1), f, axis=2)
    save_image_grid(up, os.path.join(args.outdir, "base_upsampled.png"), data_range=view)
    save_image_grid(sr_np, os.path.join(args.outdir, "sr.png"), data_range=view)
    np.save(os.path.join(args.outdir, "sr_samples.npy"), sr_np)
    metrics = {
        "n": int(sr_np.shape[0]),
        "base_px": base.image_size,
        "sr_px": sr.image_size,
        "factor": f,
        "base_steps": args.base_steps,
        "sr_steps": args.sr_steps,
        "cascade_rmse": float(np.mean(rmses)),
        "wall_s": wall,
        "img_per_s": args.n / wall,
    }
    with open(os.path.join(args.outdir, "cascade_metrics.json"), "w") as fh:
        json.dump(metrics, fh, indent=2)
    print(json.dumps(metrics))
    return {**metrics, "chunk_seconds": chunk_seconds, "sr_samples": sr_np}


if __name__ == "__main__":
    main(parse_args())
