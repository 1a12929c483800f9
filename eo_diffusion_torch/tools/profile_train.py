"""Where a training step's time goes on the GPU: the clouds UNet at 256 px,
or any preset's backbone and process.

    python -m eo_diffusion_torch.tools.profile_train [--batch_size 8] [--steps 3]
    python -m eo_diffusion_torch.tools.profile_train --image_size 512 --batch_size 4
    python -m eo_diffusion_torch.tools.profile_train --preset dit256 --batch_size 16
    python -m eo_diffusion_torch.tools.profile_train --preset latent256-cr --batch_size 32

Builds the preset's trainer (by default ``sen12mscr256``: concat cloud
removal; ``dit256``: DiT-B/8 with rectified flow; bf16 activations, float32
parameters, AdamW + EMA) with seeded random weights and takes training steps
on synthetic batches of the preset's shape (a cond view of the image's shape
where the preset conditions by concat). A latent preset's trainer encodes
the batch with a seeded float32 first stage, as ``cli.train`` does after
training it; its first stage's own training step (reconstruction loss,
backward, Adam) is profiled too, under ``first_stage``. Reports, per step:

* the host-clock step time (ends in ``torch.cuda.synchronize()``);
* the device time by kernel class, from ``torch.profiler`` over ``--steps``
  steps, with the attention forward (with lse), the attention backward, the
  GroupNorm kernel's forward and backward and the conv weight gradients
  (cuDNN's wgrad kernels and the port's 2a with its partial sums) as classes
  of their own, and the device's idle share (1 - device time / step time);
* the kernels' launches per step and the peak device memory.

Prints one JSON line and writes it to ``--out`` as well.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from eo_diffusion_torch.cli.presets import build_denoiser, build_process, get_preset
from eo_diffusion_torch.models.autoencoder import ConvAutoencoder
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.ops import conv_wgrad as CW
from eo_diffusion_torch.ops import group_norm as G
from eo_diffusion_torch.train import ae_trainer as AET
from eo_diffusion_torch.train.trainer import Trainer, TrainerConfig
from eo_diffusion_torch.weights import randomize_parameters

# kernel name -> class, first match wins
_CLASSES = (
    ("attention_fwd_lse", re.compile(r"attn_fwd")),
    ("attention_bwd", re.compile(r"attn_bwd")),
    ("group_norm_fwd", re.compile(r"gn_sm90_fwd|gn_(stats|finalize|apply)")),
    ("group_norm_bwd", re.compile(r"gn_sm90_bwd|gn_(bwd|dx)")),
    ("optimizer_ema", re.compile(r"multi_tensor|foreach|adam", re.I)),
    ("conv_wgrad", re.compile(r"wgrad|sum_splits", re.I)),
    ("conv_gemm", re.compile(r"conv|gemm|xmma|cutlass|nvjet|implicit|wgrad|dgrad|fprop|sm90_",
                             re.I)),
    ("layer_norm", re.compile(r"layer_norm", re.I)),
    ("norm_reduce", re.compile(r"reduce|norm|var_mean|welford", re.I)),
    ("copy_cat", re.compile(r"copy|cat|transpose|permute|nchw|nhwc|pad", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def _classify(name: str) -> str:
    for cls, pat in _CLASSES:
        if pat.search(name):
            return cls
    return "other"


def _device_ms(run, steps: int):
    """Device ms a step by kernel class and by kernel, from torch.profiler
    over ``run()``, which takes ``steps`` steps."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    by_class, by_kernel = defaultdict(float), defaultdict(float)
    for e in prof.key_averages():
        # kernels only: a profiler annotation such as "Optimizer.step#AdamW.step"
        # also carries device time, that of the kernels inside it
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer.")):
            continue
        ms = e.self_device_time_total / 1e3 / steps
        by_class[_classify(e.key)] += ms
        by_kernel[e.key] += ms
    return by_class, by_kernel


def _first_stage(preset, x: torch.Tensor, steps: int, seed: int) -> dict:
    """A latent preset's first-stage training step (``ae_loss``, backward,
    Adam) on ``x``: host ms a step, device ms by class, idle share."""
    ae = randomize_parameters(ConvAutoencoder(preset.ae_config()), seed).to(x.device).train()
    opt = torch.optim.Adam(ae.parameters(), lr=2e-3)

    def run(k=steps):
        for _ in range(k):
            opt.zero_grad(set_to_none=True)
            AET.ae_loss(ae, x)[0].backward()
            opt.step()
        torch.cuda.synchronize()

    run(2)
    t0 = time.perf_counter()
    run()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_class, _ = _device_ms(run, steps)
    device_ms = sum(by_class.values())
    return {"step_ms": step_ms, "device_ms_per_step": device_ms,
            "idle_share": 1.0 - device_ms / step_ms,
            "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="sen12mscr256")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--image_size", type=int, default=None,
                    help="the preset's own size by default")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/profile_train.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    preset = get_preset(args.preset)
    preset.image_size = args.image_size or preset.image_size
    concat = preset.cond_type == "concat"
    cond_ch = preset.cond_channels(preset.in_channels) if concat else 0
    cfg = preset.model_config(cond_channels=cond_ch)
    model = randomize_parameters(build_denoiser(cfg), args.seed)
    diffusion = build_process(preset, preset.timesteps, preset.image_size,
                              cond_type=preset.cond_type)
    if preset.is_latent:
        ae = randomize_parameters(ConvAutoencoder(preset.ae_config()), args.seed + 1).to(dev)
        diffusion = AET.latent_process(diffusion, ae)
    n, s, c = args.batch_size, preset.image_size, preset.in_channels
    tcfg = TrainerConfig(lr=1e-4, batch_size=n, epochs=1, cond_type=preset.cond_type,
                         model_ema_steps=1, seed=args.seed,
                         preview_sampler="flow" if preset.process == "flow" else "ddpm")
    trainer = Trainer(tcfg, model, diffusion, steps_per_epoch=1000, device=dev)
    state = trainer.init()
    rng = np.random.default_rng(args.seed)
    batch = {"image": rng.uniform(-1, 1, (n, s, s, c)).astype(np.float32)}
    if concat:
        batch["cond"] = rng.uniform(-1, 1, (n, s, s, c)).astype(np.float32)

    def steps(k):
        nonlocal state
        for _ in range(k):
            state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        return metrics

    steps(2)  # warm-up: cuDNN plans, kernel build and load, optimizer state
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = steps(args.steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    A.qkv_attention_cuda.launches = A.qkv_attention_bwd_cuda.launches = 0
    A.flash_attention_cuda.launches = A.flash_attention_bwd_cuda.launches = 0
    G.group_norm_fwd_cuda.launches = G.group_norm_bwd_cuda.launches = 0
    CW.conv_wgrad_sm90_cuda.launches = 0
    by_class, by_kernel = _device_ms(lambda: steps(args.steps), args.steps)
    fwd_launches, bwd_launches = A.qkv_attention_cuda.launches, A.qkv_attention_bwd_cuda.launches
    flash_launches = A.flash_attention_cuda.launches, A.flash_attention_bwd_cuda.launches
    gn_launches = G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches
    device_ms = sum(by_class.values())

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:14]
    res = {
        "card": card.strip(),
        "config": f"{preset.name} training step ({preset.backbone}, {preset.process}) at {s} "
                  "px, bf16, AdamW + EMA every step",
        "batch_size": n, "steps": args.steps, "step_ms": step_ms,
        "steps_per_s": 1e3 / step_ms, "img_per_s": n * 1e3 / step_ms,
        "loss": float(metrics["loss"]),
        "device_ms_per_step": device_ms,
        "idle_share": (1.0 - device_ms / step_ms) if device_ms else None,
        "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[k[:90], v] for k, v in top],
        "attention_fwd_launches_per_step": fwd_launches / args.steps,
        "attention_bwd_launches_per_step": bwd_launches / args.steps,
        "flash_attention_fwd_launches_per_step": flash_launches[0] / args.steps,
        "flash_attention_bwd_launches_per_step": flash_launches[1] / args.steps,
        "group_norm_fwd_launches_per_step": gn_launches[0] / args.steps,
        "group_norm_bwd_launches_per_step": gn_launches[1] / args.steps,
        "conv_wgrad_sm90_launches_per_step": CW.conv_wgrad_sm90_cuda.launches / args.steps,
        "peak_mem_gib": peak_gib,
    }
    if preset.is_latent:
        del state, trainer, model
        res["first_stage"] = _first_stage(preset, torch.as_tensor(batch["image"], device=dev),
                                          args.steps, args.seed + 1)
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
