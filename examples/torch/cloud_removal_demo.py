"""Cloud-removal demo of the PyTorch port: the reference notebook recipe
(``EO_Diffusion.ipynb``) as a script, the port's twin of
``examples/cloud_removal_demo.py``.

The clouds config UNet (base 128, mults [1,2,3,4], attention at ds 4/8, 2
res-blocks, 8 heads, 64 x 64) samples with RePaint-"sum" conditioning on the
cloudy RGB and the inverted cloud mask: DDPM over the whole chain, or DDIM
with ``--ddim`` steps.

Usage:
    # with the published torch checkpoint (or a training checkpoint of the port):
    python examples/torch/cloud_removal_demo.py --ckpt clouds_best.pt \\
        --image cloudy.png --mask cloudmask.png --out results/demo
    # data-free demo (synthetic scenes, fresh weights), on the CPU:
    python examples/torch/cloud_removal_demo.py --synthetic --timesteps 50 --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None,
                    help="a reference .pt or a training checkpoint of the port")
    ap.add_argument("--image", type=str, default=None, help="cloudy RGB input")
    ap.add_argument("--mask", type=str, default=None, help="cloud mask (white=cloud)")
    ap.add_argument("--out", type=str, default="results/demo")
    ap.add_argument("--timesteps", type=int, default=1000)
    ap.add_argument("--ddim", type=int, default=0, help="use DDIM with this many steps")
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

    device = resolve_device(args.device, "cloud_removal_demo")
    if args.smoke:
        size = 16
        args.timesteps = min(args.timesteps, 20)
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

        ds = SyntheticEO(size=size, length=4, with_mask=True)
        items = [ds[i] for i in range(4)]
        image = np.stack([it["image"] for it in items])
        mask = np.stack([it["segmentation"] for it in items])
        print("using synthetic cloudy scenes")
    else:
        from PIL import Image

        img = np.asarray(Image.open(args.image).convert("RGB").resize((size, size)),
                         np.float32)[None] / 255.0
        m = np.asarray(Image.open(args.mask).convert("L").resize((size, size)),
                       np.float32)[None, :, :, None] / 255.0
        image, mask = img, (m > 0.5).astype(np.float32)

    # known region = NOT cloud (reference inference.py:101 inverts the mask)
    cond = np.concatenate([image, 1.0 - mask], axis=-1)
    model_fn = lambda x, t, c, y: model(x, t, cond=c, y=y)
    as_dev = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        if args.ddim:
            out = diffusion.ddim_sample(model_fn, image.shape[0], device=device, generator=gen,
                                        num_steps=args.ddim, mask=as_dev(1.0 - mask),
                                        x0=as_dev(image), clip=True)
        else:
            out = diffusion.ddpm_sample(model_fn, image.shape[0], device=device, generator=gen,
                                        cond=as_dev(cond))
    samples = out.x.float().cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    save_image_grid(image, os.path.join(args.out, "input_cloudy.png"), nrow=2)
    save_image_grid(np.repeat(mask, 3, -1), os.path.join(args.out, "cloud_mask.png"), nrow=2)
    save_image_grid(samples, os.path.join(args.out, "cloud_removed.png"), nrow=2)
    print(f"wrote input/mask/result grids to {args.out}/")
    return samples


if __name__ == "__main__":
    main()
