"""Modern-stack demo of the PyTorch port: a DiT denoiser trained with
rectified flow, the port's twin of ``examples/modern_stack_demo.py``.

Trains a small DiT with the flow-matching objective on synthetic EO tiles
(AdamW, linear warmup then cosine decay, an EMA every 10 steps with its
warm-up) and samples with a handful of Heun ODE steps from the EMA weights.
``--steps 0`` samples from fresh weights.

Usage:
    # quick CPU smoke (tiny model, 20 train steps, Heun samples):
    python examples/torch/modern_stack_demo.py --smoke --device cpu
    # a real small run (on the card):
    python examples/torch/modern_stack_demo.py --steps 3000 --out results/modern
"""

import argparse
import copy
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def warmup_cosine(step: int, peak: float, warmup: int, decay_steps: int,
                  end: float) -> float:
    """Linear warm-up from 0 to ``peak`` over ``warmup`` steps, then a cosine
    decay to ``end`` at ``decay_steps`` (optax's
    ``warmup_cosine_decay_schedule``, the JAX demo's)."""
    if step < warmup:
        return peak * step / warmup
    frac = min(step - warmup, decay_steps - warmup) / max(decay_steps - warmup, 1)
    return end + (peak - end) * 0.5 * (1.0 + math.cos(math.pi * frac))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--sample_steps", type=int, default=8)
    ap.add_argument("--out", type=str, default="results/modern_stack_demo")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config + 20 train steps (CPU-runnable)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; never falls back silently")
    args = ap.parse_args(argv)

    import torch

    from _port_demo import resolve_device
    from eo_diffusion_torch.data.datasets import SyntheticEO
    from eo_diffusion_torch.diffusion.flow import FlowMatching
    from eo_diffusion_torch.models.dit import DiT, DiTConfig, dit_s
    from eo_diffusion_torch.train.ema import ema_update_every, warmed_decay
    from eo_diffusion_torch.utils.images import save_image_grid

    device = resolve_device(args.device, "modern_stack_demo")
    if args.smoke:
        args.size, args.batch_size, args.steps = 16, 16, 20
        cfg = DiTConfig(image_size=16, in_channels=3, out_channels=3, patch_size=4,
                        hidden_size=64, depth=2, num_heads=4)
    else:
        cfg = dit_s(args.size, dtype=torch.bfloat16)
    torch.manual_seed(0)
    model = DiT(cfg).to(device)
    fm = FlowMatching.create(image_size=args.size, in_channels=3)

    ds = SyntheticEO(size=args.size, length=512, data_range=(-1.0, 1.0), seed=0)
    imgs = np.stack([ds[i]["image"] for i in range(512)])
    print(f"DiT: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params")

    ema = copy.deepcopy(model).requires_grad_(False).eval()
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    warmup = min(500, args.steps // 2 + 1)
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=device).manual_seed(1)
    model_fn = lambda x, t, c, y: model(x, t, cond=c, y=y)
    model.train()
    for i in range(args.steps):
        idx = rng.integers(0, len(imgs), args.batch_size)
        for group in opt.param_groups:
            group["lr"] = warmup_cosine(i, 1e-3, warmup, max(args.steps, 1), 1e-5)
        opt.zero_grad(set_to_none=True)
        loss = fm.train_loss(model_fn, torch.as_tensor(imgs[idx], device=device),
                             generator=gen)
        loss.backward()
        opt.step()
        ema_update_every(list(ema.parameters()), list(model.parameters()),
                         warmed_decay(0.999, i // 10), i, 10)
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i}/{args.steps} loss={loss.item():.4f}")

    os.makedirs(args.out, exist_ok=True)
    fn = lambda x, t, c, y: ema(x, t, cond=c, y=y)
    with torch.inference_mode():
        out = fm.sample(fn, 16, device=device, num_steps=args.sample_steps, method="heun",
                        generator=torch.Generator(device=device).manual_seed(7)).x
    grid = np.clip((out.float().cpu().numpy() + 1) / 2, 0, 1)
    path = os.path.join(args.out, f"samples_heun{args.sample_steps}.png")
    save_image_grid(grid, path, nrow=4)
    print(f"wrote {path}")
    return grid


if __name__ == "__main__":
    main()
