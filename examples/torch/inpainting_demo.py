"""Urban-replanning inpainting demo of the PyTorch port (the third reference
use case, README.md:29-36), the port's twin of ``examples/inpainting_demo.py``:
RePaint-regenerate a random rectangle of a scene with an unconditional
model, "replanning" a city block.

Usage:
    python examples/torch/inpainting_demo.py --ckpt logs/inria/best --image scene.png
    python examples/torch/inpainting_demo.py --synthetic --timesteps 50 --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--image", type=str, default=None)
    ap.add_argument("--out", type=str, default="results/inpaint")
    ap.add_argument("--timesteps", type=int, default=1000)
    ap.add_argument("--sampler", choices=["ddpm", "ddim"], default="ddpm")
    ap.add_argument("--ddim_steps", type=int, default=100)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + 16px scenes (CPU-runnable CI smoke)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; never falls back silently")
    args = ap.parse_args(argv)

    import torch

    from _port_demo import load_weights, resolve_device
    from eo_diffusion_torch.data.transforms import random_rect_mask
    from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
    from eo_diffusion_torch.models.unet import UNet, UNetConfig, unet_clouds
    from eo_diffusion_torch.utils.images import save_image_grid

    device = resolve_device(args.device, "inpainting_demo")
    if args.smoke:
        size = 16
        args.timesteps = min(args.timesteps, 20)
        args.ddim_steps = min(args.ddim_steps, 5)
        cfg = UNetConfig(image_size=size, in_channels=3, model_channels=16, out_channels=3,
                         num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
                         dtype=torch.bfloat16)
    else:
        size = 64
        cfg = unet_clouds(size, dtype=torch.bfloat16)
    torch.manual_seed(0)
    model = UNet(cfg)
    if args.ckpt:
        load_weights(model, args.ckpt, cfg)
    model = model.to(device).eval()
    diffusion = GaussianDiffusion.create(timesteps=args.timesteps, image_size=size,
                                         in_channels=3, cond_type="sum")

    if args.synthetic or args.image is None:
        from eo_diffusion_torch.data.datasets import SyntheticEO

        ds = SyntheticEO(size=size, length=4, with_mask=False)
        scenes = np.stack([ds[i]["image"] for i in range(4)])
    else:
        from PIL import Image

        scenes = np.asarray(Image.open(args.image).convert("RGB").resize((size, size)),
                            np.float32)[None] / 255.0

    # "replan" region = a random rectangle (reference make_label,
    # script_utils/utils.py:17-37, via inference.py --random_label)
    rng = np.random.default_rng(args.seed)
    lo, hi = max(size // 6, 2), max(size * 40 // 64, 4)
    rect = np.stack([random_rect_mask((size, size), lo, lo, hi, hi, rng)
                     for _ in range(scenes.shape[0])])
    known = 1.0 - rect  # regenerate inside the rectangle

    model_fn = lambda x, t, c, y: model(x, t, cond=c, y=y)
    as_dev = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        if args.sampler == "ddpm":
            cond = np.concatenate([scenes, known], -1)
            out = diffusion.ddpm_sample(model_fn, scenes.shape[0], device=device,
                                        generator=gen, cond=as_dev(cond), clip=True)
        else:
            out = diffusion.ddim_sample(model_fn, scenes.shape[0], device=device,
                                        generator=gen, num_steps=args.ddim_steps,
                                        mask=as_dev(known), x0=as_dev(scenes), clip=True)
    replanned = out.x.float().cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    save_image_grid(scenes, os.path.join(args.out, "original.png"), nrow=2)
    save_image_grid(np.repeat(rect, 3, -1), os.path.join(args.out, "replan_region.png"), nrow=2)
    save_image_grid(np.clip(replanned, 0, 1), os.path.join(args.out, "replanned.png"), nrow=2)
    print(f"wrote original/region/replanned grids to {args.out}/")
    return replanned


if __name__ == "__main__":
    main()
