"""Synthetic change-pair generation demo of the PyTorch port (the OSCD use
case, README.md:21-28), the port's twin of ``examples/change_pair_demo.py``.

Generates the "after" image of a change pair conditioned on the "before"
image through channel-concat conditioning: a model trained as p(t2 | t1) on
OSCD pairs, or here fresh weights on synthetic scenes.

Usage:
    python examples/torch/change_pair_demo.py --ckpt logs/oscd/best --data /data/OSCD_64_32/test
    python examples/torch/change_pair_demo.py --synthetic --timesteps 50 --device cpu
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
    ap.add_argument("--data", type=str, default=None, help="OSCD patch dir")
    ap.add_argument("--out", type=str, default="results/change_pairs")
    ap.add_argument("--timesteps", type=int, default=1000)
    ap.add_argument("--ddim", type=int, default=50)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + 16px scenes (CPU-runnable CI smoke)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; never falls back silently")
    args = ap.parse_args(argv)

    import torch

    from _port_demo import load_weights, resolve_device
    from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
    from eo_diffusion_torch.models.unet import UNet, UNetConfig, unet_clouds
    from eo_diffusion_torch.utils.images import save_image_grid

    device = resolve_device(args.device, "change_pair_demo")
    if args.smoke:
        size = 16
        args.timesteps = min(args.timesteps, 20)
        args.ddim = min(args.ddim, 5)
        cfg = UNetConfig(image_size=size, in_channels=3 + 3, model_channels=16, out_channels=3,
                         num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
                         dtype=torch.bfloat16)
    else:
        size = 64
        cfg = unet_clouds(size, in_channels=3 + 3, dtype=torch.bfloat16)  # x | t1 cond
    torch.manual_seed(0)
    model = UNet(cfg)
    if args.ckpt:
        load_weights(model, args.ckpt, cfg)
    model = model.to(device).eval()
    diffusion = GaussianDiffusion.create(timesteps=args.timesteps, image_size=size,
                                         in_channels=3, cond_type="concat")

    if args.synthetic or args.data is None:
        from eo_diffusion_torch.data.datasets import SyntheticEO

        ds = SyntheticEO(size=size, length=4)
        before = np.stack([ds[i]["image"] for i in range(4)])
        print("using synthetic 'before' scenes")
    else:
        from eo_diffusion_torch.data.datasets import OSCDDataset

        ds = OSCDDataset(args.data, return_pair=True)
        before = np.stack([ds[i]["image2"][:size, :size] for i in range(4)])

    model_fn = lambda x, t, c, y: model(x, t, cond=c, y=y)
    with torch.inference_mode():
        out = diffusion.ddim_sample(
            model_fn, before.shape[0], device=device,
            generator=torch.Generator(device=device).manual_seed(0), num_steps=args.ddim,
            cond=torch.as_tensor(before, dtype=torch.float32, device=device), clip=True)
    after = out.x.float().cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    save_image_grid(before, os.path.join(args.out, "before.png"), nrow=2)
    save_image_grid(np.clip(after, 0, 1), os.path.join(args.out, "after_generated.png"), nrow=2)
    print(f"wrote before/after grids to {args.out}/")
    return after


if __name__ == "__main__":
    main()
