"""Sampling CLI of the port (the main-path flags of ``eo_diffusion_tpu.cli.inference``).

``python -m eo_diffusion_torch.cli.inference --preset sen12mscr256
--dataset sen12mscr --data_root /data/SEN12MS_CR --ckpt logs/run/best
--sampler ddim --sampler_steps 50 --batch_size 8 --save``

``python -m eo_diffusion_torch.cli.inference --preset dit256 --sampler flow
--flow_method heun --sampler_steps 8 --batch_size 8``

Runs on the GPU (``--device cuda``, the default) and raises when there is
none; the CPU is used only with ``--device cpu``. It conditions on the
test split of any dataset of ``DATASET_FACTORIES`` (``--dataset``, from
``--data_root``). It writes the same
``samples/`` PNG grids as the JAX CLI. UNet and DiT presets sample with
DDPM/DDIM; flow-process presets (``dit256``, ``flow64``, ``tiny-flow``) with
``--sampler flow``, which they force. ``--metrics`` scores each conditioned
batch's samples against the ground truth (SSIM and PSNR on the device, in
[0, 1]), prints the running means and writes them to ``<outdir>/metrics.txt``;
``--samples_fid`` writes every sample as its own PNG under
``<outdir>/samples_fid/`` for ``cli.evaluate``; ``--wandb`` is parsed and, as
in the JAX CLI, does nothing here. Flags of the JAX CLI that later slices
bring (guidance, DeepCache, other samplers, latent presets, ...) exit naming
their ROADMAP queue.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

# flags of the JAX sampling CLI that are not ported yet -> ROADMAP queue; a
# name ending in "_" stands for every flag that starts with it
UNPORTED_FLAGS = {
    "--ae_ckpt": 10,
    "--guidance_scale": 11, "--guidance_rescale": 11, "--guidance_interval": 11,
    "--dynamic_threshold": 11, "--dpm_spacing": 11, "--sigma_data": 11, "--cd_points": 11,
    "--deepcache": 11, "--sdedit_strength": 11, "--pag_scale": 11, "--autoguide_": 11,
    "--classifier_": 11, "--phema_": 11, "--random_label": 11, "--num_classes": 11,
    "--class_dropout": 11, "--cond_type": 11, "--model_base_dim": 11,
    "--freeu": 13, "--tome_ratio": 13, "--tome_mlp": 13, "--controlnet": 13,
    "--lora": 14, "--int8_compute": 15,
}
# samplers of the JAX CLI that are not ported yet -> ROADMAP queue
UNPORTED_SAMPLERS = {"dpm": 11, "unipc": 11, "cm": 12, "pd": 12}


def _unported_flag(arg: str):
    flag = arg.split("=")[0]
    for name, queue in UNPORTED_FLAGS.items():
        if flag == name or (name.endswith("_") and flag.startswith(name)):
            return flag, queue
    return None


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="EO diffusion inference (PyTorch/CUDA)")
    parser.add_argument("--preset", type=str, default="inria64")
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--data_root", type=str, default=None,
                        help="the dataset's root directory (the factory's root=)")
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--timesteps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--sampler", type=str, default="ddpm",
                        choices=["ddpm", "ddim", "flow", *UNPORTED_SAMPLERS],
                        help="flow = the ODE sampler of flow-process presets, which force it")
    parser.add_argument("--flow_method", type=str, default="euler", choices=["euler", "heun"],
                        help="flow sampler integrator (heun: 2nd order, 2 model calls a step)")
    parser.add_argument("--sampler_steps", type=int, default=250)
    parser.add_argument("--eta", type=float, default=0.0)
    parser.add_argument("--ddim_spacing", type=str, default="uniform",
                        choices=["uniform", "quad", "trailing"])
    parser.add_argument("--ddim_clip", action="store_true",
                        help="clamp pred_x0 in DDIM steps (the reference DDIM never clips)")
    parser.add_argument("--no_clip", action="store_true",
                        help="ddpm: posterior mean from eps instead of the clipped x0")
    parser.add_argument("--jump_len", type=int, default=0,
                        help="RePaint resampling jump length (ddpm sampler)")
    parser.add_argument("--jump_n", type=int, default=1,
                        help="RePaint resamplings per jump point (1 = single descent)")
    parser.add_argument("--ckpt", type=str, default="",
                        help="a reference .pt checkpoint or a saved port state dict")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n_iter", type=int, default=None,
                        help="stop after batch index n_iter (0 = one batch)")
    parser.add_argument("--no_bf16", action="store_true")
    parser.add_argument("--outdir", type=str, default="results/run")
    parser.add_argument("--metrics", action="store_true",
                        help="SSIM/PSNR of the samples against the ground truth")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--samples_fid", action="store_true",
                        help="write each sample as a PNG under <outdir>/samples_fid")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; never falls back silently")
    for arg in (argv if argv is not None else __import__("sys").argv[1:]):
        hit = _unported_flag(arg)
        if hit:
            parser.error(f"{hit[0]} is not ported yet (ROADMAP queue {hit[1]})")
    args = parser.parse_args(argv)
    if args.sampler in UNPORTED_SAMPLERS:
        parser.error(f"--sampler {args.sampler} is not ported yet "
                     f"(ROADMAP queue {UNPORTED_SAMPLERS[args.sampler]})")
    return args


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("eo_diffusion_torch.cli.inference: no CUDA device is "
                         "available; pass --device cpu to sample on the CPU")
    return device


def _build_cond(batch, cond_type):
    """(cond, mask) for one batch (reference inference.py:98-109): a paired
    "cond_image" view is the concat conditioning; otherwise (image | mask)
    with the mask inverted for ``cond_type="sum"`` (known = non-cloud)."""
    if cond_type is None:
        return None, None
    image = np.asarray(batch["image"], np.float32)
    if cond_type == "concat" and "cond_image" in batch:
        return np.asarray(batch["cond_image"], np.float32), None
    mask = (np.asarray(batch["segmentation"], np.float32)
            if "segmentation" in batch else None)
    if mask is None:
        return None, None
    if cond_type == "sum":
        mask = 1.0 - mask
    return np.concatenate([image, mask], axis=-1), mask


def main(args):
    """Sample ``args.n_iter + 1`` batches. Returns a summary dict with the
    last batch's samples (``[N, H, W, C]`` float32 numpy), the batch and
    image counts and the seconds spent inside the samplers, in all and by
    batch; with ``--metrics`` also the mean ``ssim`` and ``psnr``."""
    from eo_diffusion_torch.cli.presets import build_denoiser, build_process, get_preset
    from eo_diffusion_torch.data.factories import DATASET_FACTORIES
    from eo_diffusion_torch.utils import metrics as M
    from eo_diffusion_torch.utils.images import rescale_to_unit, save_image_grid
    from eo_diffusion_torch.weights import load_reference_checkpoint

    device = resolve_device(args.device)
    preset = get_preset(args.preset)
    dataset = args.dataset or preset.dataset
    factory = DATASET_FACTORIES[dataset]
    image_size = args.image_size or preset.image_size
    preset.image_size = image_size
    timesteps = args.timesteps or preset.timesteps
    cond_type = preset.cond_type
    if preset.process == "flow" and args.sampler != "flow":
        print(f"preset {preset.name} is a flow process; using --sampler flow "
              "(its native sampler)")
        args.sampler = "flow"
    if args.sampler == "flow" and preset.process != "flow":
        raise SystemExit(f"--sampler flow requires a flow-process preset; {preset.name} "
                         f"trained the {preset.process} chain (use ddpm/ddim)")

    fkw = dict(batch_size=args.batch_size, test=True)
    if args.data_root:
        fkw["root"] = args.data_root
    if dataset == "synthetic":
        fkw["image_size"] = image_size
        fkw["channels"] = preset.in_channels
        if cond_type == "concat":
            fkw["with_cond_image"] = True  # synthetic cloudy view as cond
        fkw.pop("test")
    _, test_loader = factory(**fkw)
    data_range = test_loader.dataset.data_range
    peek = {k: np.asarray(v)[None] for k, v in test_loader.dataset[0].items()}
    peek_cond, _ = _build_cond(peek, cond_type)
    cond_channels = peek_cond.shape[-1] if cond_type == "concat" and peek_cond is not None else 0

    ucfg = preset.model_config(bf16=not args.no_bf16, cond_channels=cond_channels)
    model = build_denoiser(ucfg)
    if args.ckpt:
        print("loading checkpoint...")
        model.load_state_dict(load_reference_checkpoint(args.ckpt, ucfg), strict=True)
        print("loaded!")
    model = model.to(device).eval()
    diffusion = build_process(preset, timesteps, image_size, cond_type=cond_type)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Diffusion with {n_params / 1e6} M params on {device}")
    model_fn = lambda x, t, c, y: model(x, t, cond=c, y=y)

    dir_samples = os.path.join(args.outdir, "samples")
    dir_fid = os.path.join(args.outdir, "samples_fid")
    os.makedirs(dir_samples, exist_ok=True)
    os.makedirs(dir_fid, exist_ok=True)
    offset = len(os.listdir(dir_samples)) // (1 if cond_type is None else 3)

    print("start inference")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    to_dev = lambda a: None if a is None else torch.as_tensor(a, device=device)
    samples, n_images, batch_seconds, n = None, 0, [], 0
    ssim_sum, psnr_sum = 0.0, 0.0
    with torch.inference_mode():
        for j, batch in enumerate(test_loader):
            print(f"data {j}")
            image = np.asarray(batch["image"], np.float32)
            bsz = image.shape[0]
            cond, mask = _build_cond(batch, cond_type)
            t0 = time.perf_counter()
            if args.sampler == "flow":
                mask_j = to_dev(mask) if cond_type == "sum" else None
                out = diffusion.sample(
                    model_fn, bsz, device=device, generator=generator,
                    num_steps=args.sampler_steps, method=args.flow_method,
                    cond=to_dev(cond) if cond_type == "concat" else None,
                    mask=mask_j, x0=to_dev(image) if mask_j is not None else None)
            elif args.sampler == "ddpm":
                out = diffusion.ddpm_sample(
                    model_fn, bsz, device=device, generator=generator,
                    cond=to_dev(cond), clip=not args.no_clip,
                    jump_len=args.jump_len, jump_n=args.jump_n)
            else:
                mask_j = to_dev(mask) if cond_type == "sum" else None
                out = diffusion.ddim_sample(
                    model_fn, bsz, device=device, generator=generator,
                    num_steps=args.sampler_steps, eta=args.eta, method=args.ddim_spacing,
                    cond=to_dev(cond) if cond_type == "concat" else None,
                    mask=mask_j, x0=to_dev(image) if mask_j is not None else None,
                    clip=args.ddim_clip)
            samples = out.x.float().cpu().numpy()  # waits for the device
            batch_seconds.append(time.perf_counter() - t0)
            n_images += bsz

            samples01 = rescale_to_unit(samples, data_range)
            idx = j + offset
            nrow = int(math.sqrt(bsz)) or 1
            if cond is not None:
                gt01 = rescale_to_unit(image, data_range)
                if args.metrics:  # on the device, from the [0, 1] samples
                    s01, g01 = (torch.as_tensor(a, device=device) for a in (samples01, gt01))
                    ssim_sum += float(M.ssim(s01, g01))
                    psnr_sum += float(M.psnr(s01, g01))
                if args.save:
                    cond_vis = (image * np.clip(mask + 0.7, 0, 1) if mask is not None
                                else cond[..., :image.shape[-1]])
                    save_image_grid(gt01, os.path.join(dir_samples, f"sample_{idx}_gt.png"),
                                    nrow=nrow)
                    save_image_grid(rescale_to_unit(cond_vis, data_range),
                                    os.path.join(dir_samples, f"sample_{idx}_cond.png"), nrow=nrow)
            if args.samples_fid:  # no class labels in the port's sampling: "sample"
                for i in range(bsz):
                    save_image_grid(samples01[i], os.path.join(dir_fid, f"sample_{idx}-{i}.png"))
            if args.save:
                save_image_grid(samples01, os.path.join(dir_samples, f"sample_{idx}.png"),
                                nrow=nrow)
            n += 1
            if args.metrics:
                print("metrics: ", ssim_sum / n, psnr_sum / n)
                with open(os.path.join(args.outdir, "metrics.txt"), "w") as f:
                    f.write(f"ssim: {ssim_sum / n}\n")
                    f.write(f"psnr: {psnr_sum / n}\n")
                    f.write(f"length: {n}\n")
            if args.n_iter is not None and j >= args.n_iter:
                break
    res = {"samples": samples, "batches": n, "images": n_images,
           "sample_seconds": sum(batch_seconds), "batch_seconds": batch_seconds}
    if args.metrics and n:
        res.update(ssim=ssim_sum / n, psnr=psnr_sum / n)
    return res


if __name__ == "__main__":
    main(parse_args())
