"""Zero-shot restoration CLI (DDNM, arXiv:2212.00490), the port of
``eo_diffusion_tpu.cli.restore``.

``python -m eo_diffusion_torch.cli.restore --preset inria64 --ckpt logs/run/best
--task sr4 --sampler_steps 100 --metrics --save``

Restores test-split images through a plain unconditional DDPM checkpoint:
super-resolution (``sr2`` / ``sr4``), inpainting (``inpaint``: the dataset's
segmentation marks the region to regenerate, else a random rectangle) and
colorization (``colorize``), with no task-specific training: the
degradation's null-space projection rides the DDIM loop
(``diffusion/inverse.py``). ``--ensemble K`` samples K stochastic
restorations of each batch (eta > 0), reports their mean as the
restoration and their per-pixel std as an uncertainty map
(``*_uncertainty.png``; ``--metrics`` adds the uncertainty-against-|error|
Pearson correlation). ``--metrics`` reports SSIM / PSNR of the restoration
and of the naive ``A+ y`` against the ground truth (``<outdir>/metrics.txt``);
``--save`` writes ``<task>_<j>_{gt,input,restored}.png``.

Runs on the GPU (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` restores on the CPU. The denoiser's attention and
norms run their kernels on the card.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from eo_diffusion_torch.cli.common import resolve_device

TASKS = ("sr2", "sr4", "inpaint", "colorize")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DDNM zero-shot restoration (PyTorch/CUDA)")
    p.add_argument("--task", type=str, default="sr4", choices=TASKS)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--sampler_steps", type=int, default=100)
    p.add_argument("--eta", type=float, default=0.85,
                   help="DDIM eta inside DDNM (paper default 0.85)")
    p.add_argument("--ensemble", type=int, default=1,
                   help="K>1: K stochastic restorations per batch (needs eta>0); their mean "
                        "is the restoration, their per-pixel std an uncertainty map")
    p.add_argument("--outdir", type=str, default="results/restore")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--metrics", action="store_true")
    p.add_argument("--save", action="store_true")
    p.add_argument("--n_iter", type=int, default=None)
    p.add_argument("--preset", type=str, default="inria64")
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--no_bf16", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; never falls back silently")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def build_operator(task, image_size, batch, mask_rng, channels, device="cpu"):
    """The degradation A of one batch: the observed region for ``inpaint``
    is the complement of the segmentation (or of a random rectangle)."""
    from eo_diffusion_torch.diffusion import inverse as I

    if task in ("sr2", "sr4"):
        return I.sr_operator(int(task[2:]))
    if task == "colorize":
        return I.gray_operator(channels)
    if "segmentation" in batch:
        m = 1.0 - np.asarray(batch["segmentation"], np.float32)
    else:
        from eo_diffusion_torch.data.transforms import random_rect_mask

        n = np.asarray(batch["image"]).shape[0]
        m = 1.0 - np.stack([random_rect_mask((image_size, image_size), 10, 10, 40, 40, mask_rng)
                            for _ in range(n)])
    return I.inpaint_operator(torch.as_tensor(m, dtype=torch.float32, device=device))


def main(args):
    """Restore ``args.n_iter + 1`` batches. Returns the last batch's
    ``restored`` and ``gt`` (numpy), the batch and image
    counts, the seconds spent restoring, ``range_err`` (the largest
    ``||A(x) - y|| / ||y||`` of any batch) and, with ``--metrics``, the
    means written to metrics.txt."""
    from eo_diffusion_torch.cli.presets import build_denoiser, build_process, get_preset
    from eo_diffusion_torch.data.factories import DATASET_FACTORIES
    from eo_diffusion_torch.diffusion.inverse import ddnm_sample
    from eo_diffusion_torch.utils import metrics as M
    from eo_diffusion_torch.utils.images import rescale_to_unit, save_image_grid
    from eo_diffusion_torch.weights import load_reference_checkpoint

    device = resolve_device(args.device, "eo_diffusion_torch.cli.restore")
    preset = get_preset(args.preset)
    assert preset.process == "ddpm" and not preset.is_latent, (
        "DDNM projects pixel-space x0 predictions along the DDPM chain; "
        f"preset {preset.name} ({preset.process}{', latent' if preset.is_latent else ''}) "
        "is not wired")
    assert args.ensemble == 1 or args.eta > 0, (
        "--ensemble needs stochastic DDNM (eta > 0); eta=0 members are identical")
    dataset = args.dataset or preset.dataset
    image_size = args.image_size or preset.image_size
    preset.image_size = image_size
    timesteps = args.timesteps or preset.timesteps

    fkw = dict(batch_size=args.batch_size, test=True)
    if args.data_root:
        fkw["root"] = args.data_root
    if dataset == "synthetic":
        fkw["image_size"] = image_size
        fkw["channels"] = preset.in_channels
        fkw.pop("test")
    _, test_loader = DATASET_FACTORIES[dataset](**fkw)
    data_range = test_loader.dataset.data_range

    ucfg = preset.model_config(bf16=not args.no_bf16)
    model = build_denoiser(ucfg)
    model.load_state_dict(load_reference_checkpoint(args.ckpt, ucfg), strict=True)
    model = model.to(device).eval()
    diffusion = build_process(preset, timesteps, image_size, cond_type=None)
    fn = lambda x, t, c, yy: model(x, t, cond=c, y=yy)

    os.makedirs(args.outdir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    mask_rng = np.random.default_rng(args.seed)
    acc = {"ssim": 0.0, "psnr": 0.0, "ssim_naive": 0.0, "psnr_naive": 0.0}
    if args.ensemble > 1:
        acc["unc_err_corr"] = 0.0
    n, n_images, seconds, range_err = 0, 0, 0.0, 0.0
    print(f"restoring: task={args.task}, {args.sampler_steps} steps, eta={args.eta}")
    with torch.inference_mode():
        for j, batch in enumerate(test_loader):
            gt = torch.as_tensor(np.asarray(batch["image"], np.float32), device=device)
            op = build_operator(args.task, image_size, batch, mask_rng, preset.in_channels,
                                device)
            y = op.forward(gt)
            naive = op.pinv(y)
            t0 = time.perf_counter()
            members = [ddnm_sample(diffusion, fn, y, op, num_steps=args.sampler_steps,
                                   eta=args.eta, device=device, generator=generator).x
                       for _ in range(args.ensemble)]
            stack = torch.stack(members)
            restored = stack.mean(dim=0)
            restored_np = restored.cpu().numpy()  # waits for the device
            seconds += time.perf_counter() - t0
            n_images += gt.shape[0]
            range_err = max(range_err, float(torch.linalg.vector_norm(op.forward(restored) - y)
                                             / torch.linalg.vector_norm(y)))
            gt_np = gt.cpu().numpy()
            gt01 = rescale_to_unit(gt_np, data_range)
            rest01 = rescale_to_unit(restored_np, data_range)
            naive01 = np.clip(rescale_to_unit(naive.cpu().numpy(), data_range), 0, 1)
            nrow = int(math.sqrt(gt01.shape[0])) or 1
            if args.ensemble > 1:
                unc = stack.std(dim=0, correction=0).cpu().numpy()
                u, e_ = unc.ravel(), np.abs(restored_np - gt_np).ravel()
                corr = float(np.corrcoef(u, e_)[0, 1]) if u.std() > 0 else 0.0
                if args.metrics:
                    acc["unc_err_corr"] += corr
                if args.save:
                    save_image_grid(unc / max(float(unc.max()), 1e-8),
                                    os.path.join(args.outdir, f"{args.task}_{j}_uncertainty.png"),
                                    nrow=nrow)
            if args.metrics:
                g01 = torch.as_tensor(gt01, device=device)
                for key, img in (("", rest01), ("_naive", naive01)):
                    i01 = torch.as_tensor(img, device=device)
                    acc[f"ssim{key}"] += float(M.ssim(i01, g01))
                    acc[f"psnr{key}"] += float(M.psnr(i01, g01))
            n += 1
            if args.save:
                for tag, img in (("gt", gt01), ("input", naive01), ("restored", rest01)):
                    save_image_grid(img, os.path.join(args.outdir, f"{args.task}_{j}_{tag}.png"),
                                    nrow=nrow)
            if args.metrics:
                print(f"batch {j}: ssim {acc['ssim'] / n:.4f} (naive {acc['ssim_naive'] / n:.4f}) "
                      f"psnr {acc['psnr'] / n:.2f} (naive {acc['psnr_naive'] / n:.2f})")
                with open(os.path.join(args.outdir, "metrics.txt"), "w") as f:
                    for k, v in acc.items():
                        f.write(f"{k}: {v / n}\n")
                    f.write(f"length: {n}\n")
            if args.n_iter is not None and j >= args.n_iter:
                break
    res = {"restored": restored_np, "gt": gt_np, "batches": n, "images": n_images,
           "sample_seconds": seconds, "range_err": range_err}
    if args.metrics and n:
        res.update({k: v / n for k, v in acc.items()})
    return res


if __name__ == "__main__":
    main(parse_args())
