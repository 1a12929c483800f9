"""Where a sampling step's time goes on the GPU: the clouds UNet at 256 px, or the DiT.

    python -m eo_diffusion_torch.tools.profile_sample [--preset sen12mscr256] [--batch_size 8] [--steps 5]
    python -m eo_diffusion_torch.tools.profile_sample --image_size 512
    python -m eo_diffusion_torch.tools.profile_sample --preset dit256 --flow_method heun --steps 8
    python -m eo_diffusion_torch.tools.profile_sample --preset latent256-cr --flow_method heun --steps 8
    python -m eo_diffusion_torch.tools.profile_sample --preset dit256 --flow_method heun --steps 8 \
        --tome_ratio 0.375 --tome_mlp

Builds the preset's denoiser (by default ``sen12mscr256``, concat cloud
removal; ``clouds64-attn`` is the reference's 64 px UNet; ``dit256`` and
``dit64`` the DiT) in bf16 with seeded random weights and runs sampler steps
on synthetic inputs of its shape (with a concat condition where the preset
has one): DDIM, or for a flow-process preset the flow sampler, whose Heun
step makes two model calls (one on the last interval). A latent preset
samples on its latent grid behind a seeded float32 first stage, which
encodes the cond view and decodes the result once a batch, as
``cli.inference`` does; its encode and decode are timed apart
(``first_stage_ms``). Reports, per step:

* the host-clock step time (ends in ``torch.cuda.synchronize()``);
* the device time by kernel class (attention kernel, GroupNorm kernel,
  convolutions and matrix products, LayerNorm, other reductions,
  elementwise, copies),
  from ``torch.profiler`` over ``--steps`` steps, and the device's idle
  share (1 - device time / step time);
* the kernels' launches per step (the attention's fused-qkv and
  separate-tensor entries apart);
* the forward time with the kernels against the plain attention and
  norms, from CUDA events (the plain one up to 256 px: beyond, its
  ``[B, H, T, T]`` f32 scores at batch 8 take tens of GB);
* the host operations of most self time (``host_top_ms``), where a wait
  for the device (a copy to the host, a synchronize) shows.

``--tome_ratio`` / ``--tome_mlp`` merge a DiT preset's tokens as the
sampling CLI's flags do.

Prints one JSON line and writes it to ``--out`` as well.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import time
from collections import defaultdict

import torch

from eo_diffusion_torch.cli.presets import build_denoiser, build_process, get_preset
from eo_diffusion_torch.models.autoencoder import ConvAutoencoder
from eo_diffusion_torch.models.dit import DiT
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.ops import group_norm as G
from eo_diffusion_torch.train.ae_trainer import latent_process
from eo_diffusion_torch.weights import randomize_parameters

# kernel name -> class, first match wins
_CLASSES = (
    ("attention", re.compile(r"attn_fwd")),
    ("group_norm", re.compile(r"gn_sm90_fwd|gn_(stats|finalize|apply)")),
    ("conv_gemm", re.compile(r"conv|gemm|xmma|cutlass|nvjet|implicit|wgrad|dgrad|fprop|sm90_",
                             re.I)),
    ("layer_norm", re.compile(r"layer_?norm", re.I)),
    ("norm_reduce", re.compile(r"reduce|norm|var_mean|welford", re.I)),
    ("copy_cat", re.compile(r"copy|cat|transpose|permute|nchw|nhwc|pad", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def _classify(name: str) -> str:
    for cls, pat in _CLASSES:
        if pat.search(name):
            return cls
    return "other"


def _cuda_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="sen12mscr256")
    ap.add_argument("--image_size", type=int, default=None, help="default: the preset's")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--flow_method", choices=["euler", "heun"], default="euler",
                    help="the flow sampler's integrator (flow-process presets)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tome_ratio", type=float, default=0.0,
                    help="DiT presets: token merging inside every block (ops/tome.py)")
    ap.add_argument("--tome_mlp", action="store_true")
    ap.add_argument("--out", default="results/profile_sample.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sample: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    preset = get_preset(args.preset)
    preset.image_size = args.image_size or preset.image_size
    sampler = "flow" if preset.process == "flow" else "ddim"
    concat = preset.cond_type == "concat"
    cond_ch = preset.cond_channels(preset.in_channels) if concat else 0
    cfg = preset.model_config(cond_channels=cond_ch)
    if args.tome_ratio:
        cfg = dataclasses.replace(cfg, tome_ratio=args.tome_ratio, tome_mlp=args.tome_mlp)
    model = randomize_parameters(build_denoiser(cfg), args.seed).to(dev).eval()
    diffusion = build_process(preset, preset.timesteps, preset.image_size,
                              cond_type=preset.cond_type if concat else None)
    if preset.is_latent:
        ae = randomize_parameters(ConvAutoencoder(preset.ae_config()), args.seed + 1).to(dev)
        diffusion = latent_process(diffusion, ae)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    n, s, c = args.batch_size, preset.image_size, preset.in_channels
    gs, gc = (preset.latent_size, preset.latent_channels) if preset.is_latent else (s, c)
    x_T = torch.randn(n, gs, gs, gc, generator=g, device=dev)
    cond = torch.rand(n, s, s, c, generator=g, device=dev) if concat else None
    calls = [0]

    def model_fn(x, t, cc, y):
        calls[0] += 1
        return model(x, t, cond=cc, y=y)

    def sample(steps):
        if sampler == "flow":
            return diffusion.sample(model_fn, n, device=dev, num_steps=steps,
                                    method=args.flow_method, cond=cond, x_T=x_T,
                                    dtype=cfg.dtype).x
        return diffusion.ddim_sample(model_fn, n, device=dev, num_steps=steps, cond=cond,
                                     x_T=x_T, dtype=cfg.dtype).x

    with torch.inference_mode():
        sample(2)  # warm-up: cuDNN plans, kernel build and load
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(args.steps)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        A.qkv_attention_cuda.launches = G.group_norm_fwd_cuda.launches = 0
        A.flash_attention_cuda.launches = calls[0] = 0
        with torch.profiler.profile(activities=acts) as prof:
            sample(args.steps)
            torch.cuda.synchronize()
        launches = A.qkv_attention_cuda.launches
        flash_launches = A.flash_attention_cuda.launches
        model_calls = calls[0]
        gn_launches = G.group_norm_fwd_cuda.launches
        by_class, by_kernel = defaultdict(float), defaultdict(float)
        host = sorted(((e.key, e.self_cpu_time_total / 1e3 / args.steps)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda kv: -kv[1])[:12]
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = e.self_device_time_total / 1e3 / args.steps
            by_class[_classify(e.key)] += ms
            by_kernel[e.key] += ms
        device_ms = sum(by_class.values())

        xin = x_T.to(cfg.dtype)
        t = torch.full((n,), 500, device=dev, dtype=torch.long)
        first_stage_ms = None
        mcond = cond
        if preset.is_latent:
            pixels = cond if concat else torch.rand(n, s, s, c, generator=g, device=dev)
            first_stage_ms = {"encode": _cuda_ms(lambda: diffusion.encode(pixels), 3),
                              "decode": _cuda_ms(lambda: diffusion.decode(x_T), 3)}
            mcond = diffusion.encode(cond) if concat else None
        fwd_kernel_ms = _cuda_ms(lambda: model(xin, t, cond=mcond), 5)
        fwd_plain_ms = None
        if s <= 256:
            if isinstance(model, DiT):
                model.set_impl(attn="plain")
            else:
                model.set_impl(attn="plain", norm="plain")
            fwd_plain_ms = _cuda_ms(lambda: model(xin, t, cond=mcond), 3)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    res = {
        "card": card.strip(),
        "config": f"{args.preset} at {s} px, "
                  f"{'flow ' + args.flow_method if sampler == 'flow' else 'DDIM'}, bf16"
                  + (f", tome_ratio {args.tome_ratio}{' + MLP' if args.tome_mlp else ''}"
                     if args.tome_ratio else ""),
        "batch_size": n, "steps": args.steps, "step_ms": step_ms,
        "model_calls_per_step": model_calls / args.steps,
        "img_per_s_at_50_steps": n / (step_ms * 50 / 1e3),
        "img_per_s_at_these_steps": n / (step_ms * args.steps / 1e3),
        "device_ms_per_step": device_ms,
        "idle_share": (1.0 - device_ms / step_ms) if device_ms else None,
        "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[k[:90], v] for k, v in top],
        "host_top_ms": [[k[:90], v] for k, v in host],
        "first_stage_ms": first_stage_ms,
        "forward_ms_kernels": fwd_kernel_ms,
        "forward_ms_plain": fwd_plain_ms,
        "attention_launches_per_step": launches / args.steps,
        "flash_attention_launches_per_step": flash_launches / args.steps,
        "group_norm_launches_per_step": gn_launches / args.steps,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
