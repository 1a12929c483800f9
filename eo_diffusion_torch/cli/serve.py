"""Serving CLI of the port: always-warm batched sampling behind an HTTP API
(counterpart of ``eo_diffusion_tpu/cli/serve.py``).

``python -m eo_diffusion_torch.cli.serve --preset sen12mscr256
--ckpt logs/run/best --sampler ddim --sampler_steps 50 --port 8000``

Builds one fixed-shape sampler at start-up (``serving/engine.py``), then
coalesces concurrent ``POST /v1/generate`` requests into full device
batches. Conditioning matches the sampling CLI: class labels (``"y"``),
concat cond images (``"cond_b64"``), classifier-free guidance fixed at
start-up. Runs on the card unless given ``--device cpu``. ``--ckpt`` is a
checkpoint directory of ``cli.train`` (the EMA weights of its latest
checkpoint are served), a port checkpoint file or a reference ``.pt``
(:func:`load_weights`); without one the weights are a seeded fresh init (a
smoke run). A port seed
reproduces within the port, not the JAX package's bytes
(``serving/seeding.py``).
"""

from __future__ import annotations

import argparse
import os

# flags of the JAX serving CLI that are not ported yet -> ROADMAP queue
UNPORTED_FLAGS = {"--dp": 16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EO diffusion serving (PyTorch/CUDA)")
    p.add_argument("--preset", type=str, default="clouds64-attn")
    p.add_argument("--ckpt", type=str, default="",
                   help="cli.train checkpoint directory or file (EMA weights are served) "
                        "or reference .pt; empty = seeded fresh init (smoke only)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=8,
                   help="fixed device batch; requests coalesce into it")
    p.add_argument("--batch_window_ms", type=float, default=20.0,
                   help="max wait after the first request to fill a batch")
    p.add_argument("--sampler", type=str, default="ddim",
                   choices=["ddpm", "ddim", "dpm", "unipc", "flow", "bridge"])
    p.add_argument("--sampler_steps", type=int, default=50)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--ddim_spacing", type=str, default="uniform",
                   choices=["uniform", "quad", "trailing"])
    p.add_argument("--flow_method", type=str, default="euler", choices=["euler", "heun"])
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--pag_scale", type=float, default=0.0,
                   help="perturbed-attention guidance (arXiv:2403.17377): self-attention -> "
                        "identity degraded branch, no condition needed; ddpm/ddim/dpm/unipc/flow")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 serving (utils/quantize.py): weights stored as "
                        "per-channel int8 + scales, dequantized on every batch (W8A16)")
    p.add_argument("--int8_compute", action="store_true",
                   help="W8A8: large Dense products as int8 x int8 -> int32 "
                        "(nn/primitives.int8_dense_compute); a DiT-preset lever")
    p.add_argument("--guidance_rescale", type=float, default=0.0,
                   help="CFG-rescale phi (arXiv:2305.08891 §3.4)")
    p.add_argument("--guidance_interval", type=str, default=None, metavar="LO,HI",
                   help="limited guidance interval (arXiv:2404.07724), normalized noise "
                        "level in [0,1]")
    p.add_argument("--dynamic_threshold", type=float, default=None, metavar="P",
                   help="Imagen dynamic thresholding percentile (arXiv:2205.11487); "
                        "ddpm/ddim/dpm/unipc")
    p.add_argument("--num_classes", type=int, default=0)
    p.add_argument("--class_dropout", type=float, default=0.0,
                   help="must match training (builds the null-class row label-CFG guides "
                        "against)")
    p.add_argument("--cond_type", type=str, default=None)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--no_bf16", action="store_true")
    p.add_argument("--dp", action="store_true",
                   help="shard each device batch over the visible cards (not ported yet)")
    p.add_argument("--ae_ckpt", type=str, default=None,
                   help="latent presets: trained first-stage directory (default: 'ae' beside "
                        "--ckpt)")
    p.add_argument("--data_range", type=float, nargs=2, default=None, metavar=("LO", "HI"),
                   help="training data range for PNG rescale (default: the dataset's)")
    p.add_argument("--request_timeout", type=float, default=300.0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; never falls back silently")
    for arg in (argv if argv is not None else __import__("sys").argv[1:]):
        flag = arg.split("=")[0]
        if flag in UNPORTED_FLAGS:
            p.error(f"{flag} is not ported yet (ROADMAP queue {UNPORTED_FLAGS[flag]})")
    return p.parse_args(argv)


def load_weights(path: str, cfg) -> dict:
    """The served weights of ``path``: for a checkpoint directory of
    ``cli.train`` the EMA of its latest ``steps_*`` checkpoint (else of
    ``best``), through ``train/checkpoint.py``; for a file, a port checkpoint's
    EMA, a reference ``.pt`` or a saved state dict
    (``weights.load_reference_checkpoint``)."""
    from eo_diffusion_torch.weights import load_reference_checkpoint

    if os.path.isdir(path):
        from eo_diffusion_torch.train.checkpoint import (CheckpointManager, best_dir,
                                                         restore_checkpoint)

        raw = CheckpointManager(path).restore_latest()
        if raw is None:
            assert os.path.isfile(best_dir(path)), f"no checkpoint in {path}"
            raw = restore_checkpoint(best_dir(path))
        return {k: v.float() for k, v in raw["model_ema"].items()}
    assert os.path.isfile(path), f"no checkpoint at {path}"
    return load_reference_checkpoint(path, cfg)


def build_engine(args):
    """Construct ``(SamplerEngine, BatchingEngine, meta)`` from the preset."""
    import torch

    from eo_diffusion_torch.cli.common import resolve_device
    from eo_diffusion_torch.cli.presets import build_denoiser, build_process, get_preset
    from eo_diffusion_torch.data.datasets import get_metadata
    from eo_diffusion_torch.serving.engine import BatchingEngine, SamplerEngine, ServingConfig

    device = resolve_device(args.device, "eo_diffusion_torch.cli.serve")
    preset = get_preset(args.preset)
    image_size = args.image_size or preset.image_size
    preset.image_size = image_size
    timesteps = args.timesteps or preset.timesteps
    cond_type = args.cond_type if args.cond_type is not None else preset.cond_type
    if cond_type == "none":  # explicit unconditional override: presets whose
        cond_type = None     # default is RePaint-"sum" can still be served
    num_classes = args.num_classes if args.num_classes > 0 else 0
    assert cond_type in (None, "concat"), (
        "serving supports unconditional or concat conditioning; RePaint-'sum' needs a "
        "per-request gt/mask protocol (use cli.inference)")
    if preset.process in ("flow", "edm", "meanflow"):
        args.sampler = "flow"  # the process's native sampler surface
        if preset.process == "meanflow" and args.flow_method != "euler":
            # MeanFlow's displacement IS the step; no higher-order corrector
            print("note: meanflow serving ignores --flow_method " + args.flow_method)
            args.flow_method = "euler"
    elif preset.process == "bridge":
        # translation serving: the request's cond image is the source the
        # bridge starts from; no other sampler applies
        assert cond_type == "concat", (
            "bridge presets translate the concat-cond source image; --cond_type none makes "
            "no sense here")
        assert args.guidance_scale == 1.0, (
            "the Brownian bridge has no CFG path (no uncond branch)")
        args.sampler = "bridge"

    # concat serving: the request supplies the PIXEL conditioning view; latent
    # presets encode it through the first stage (cond_via_encoder), so the
    # model-facing cond width is the latent channel count
    cond_channels = preset.in_channels if cond_type == "concat" else 0
    model_cond_ch = ((preset.latent_channels if preset.is_latent else cond_channels)
                     if cond_channels else 0)
    ucfg = preset.model_config(bf16=not args.no_bf16, cond_channels=model_cond_ch,
                               num_classes=num_classes or None,
                               class_dropout_prob=args.class_dropout)
    torch.manual_seed(args.seed)  # the fresh init of a run without --ckpt
    model = build_denoiser(ucfg)
    if args.ckpt:
        model.load_state_dict(load_weights(args.ckpt, ucfg), strict=True)
    model = model.to(device).eval()
    diffusion = build_process(preset, timesteps, image_size, cond_type=cond_type)
    if preset.is_latent:
        from eo_diffusion_torch.train import ae_trainer as AET

        # a checkpoint's first stage sits in "ae" beside it (in the directory)
        run_dir = args.ckpt if os.path.isdir(args.ckpt) else os.path.dirname(args.ckpt)
        ae_dir = args.ae_ckpt or (os.path.join(run_dir, "ae") if args.ckpt else "")
        assert AET.ae_exists(ae_dir), (
            f"latent preset {preset.name} needs a trained first stage; none at {ae_dir!r} "
            "(train one with cli.train, or pass --ae_ckpt)")
        diffusion = AET.latent_process(diffusion, *AET.load_ae(ae_dir, device=device))
    n_params = sum(p.numel() for p in model.parameters())

    has_null = bool(num_classes and (getattr(ucfg, "label_vocab", 0) or 0) > num_classes)
    if args.guidance_scale != 1.0 and num_classes and not has_null:
        print("note: label-CFG needs a null-class row (--class_dropout > 0 to match "
              "training); serving unguided")
        args.guidance_scale = 1.0
    if args.guidance_scale != 1.0 and not (num_classes or cond_channels):
        print("note: --guidance_scale needs class- or concat-conditioning; serving unguided")
        args.guidance_scale = 1.0

    scfg = ServingConfig(
        batch_size=args.batch_size, sampler=args.sampler, steps=args.sampler_steps,
        eta=args.eta, ddim_spacing=args.ddim_spacing, flow_method=args.flow_method,
        guidance_scale=args.guidance_scale, pag_scale=args.pag_scale,
        guidance_rescale=args.guidance_rescale, dynamic_threshold=args.dynamic_threshold,
        guidance_interval=(tuple(float(v) for v in args.guidance_interval.split(","))
                           if args.guidance_interval else None),
        num_classes=num_classes, has_null_class=has_null, cond_channels=cond_channels,
        bf16=not args.no_bf16, batch_window_ms=args.batch_window_ms,
        request_timeout_s=args.request_timeout, dp=args.dp, int8=args.int8,
        int8_compute=args.int8_compute)
    engine = SamplerEngine(model, None, diffusion, image_size, preset.in_channels, scfg)
    batcher = BatchingEngine(engine, base_seed=args.seed)
    if args.data_range is not None:
        lo, hi = args.data_range
    else:
        try:
            lo, hi = get_metadata(preset.dataset)["data_range"]
        except Exception:
            # the synthetic factory's default; EO presets train in [-1, 1]
            lo, hi = (0.0, 1.0) if preset.dataset == "synthetic" else (-1.0, 1.0)
    meta = {"preset": preset.name, "sampler": args.sampler, "steps": args.sampler_steps,
            "batch_size": args.batch_size, "image_size": image_size,
            "channels": preset.in_channels, "num_classes": num_classes,
            "cond_channels": cond_channels, "guidance_scale": args.guidance_scale,
            "pag_scale": args.pag_scale, "params_m": round(n_params / 1e6, 3),
            "data_range": (float(lo), float(hi)), "device": str(device)}
    return engine, batcher, meta


def reload_fn(engine):
    """``POST /v1/reload``'s function for ``engine``: swap in the served
    weights of a checkpoint path."""

    def reload(path):
        engine.swap_params(load_weights(path, engine.model.config))
        return {"ckpt": path}

    return reload


def main(args):
    from eo_diffusion_torch.serving.http import make_server, serve_forever

    engine, batcher, meta = build_engine(args)
    print(f"serving {meta['params_m']}M params | {meta}")
    warm_s = engine.warmup()
    print(f"warmup (kernel builds + first batch): {warm_s:.1f}s")
    srv, port = make_server(batcher, meta, host=args.host, port=args.port,
                            verbose=args.verbose, reload_fn=reload_fn(engine))
    print(f"listening on http://{args.host}:{port}  "
          "(POST /v1/generate, POST /v1/generate_stream, POST /v1/reload, GET /healthz, "
          "GET /stats)")
    try:
        serve_forever(srv)
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        batcher.shutdown()


if __name__ == "__main__":
    main(parse_args())
