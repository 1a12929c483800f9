"""Adapter fine-tuning CLI of the port: LoRA deltas or a ControlNet branch
(counterpart of ``eo_diffusion_tpu/cli/finetune.py``).

``python -m eo_diffusion_torch.cli.finetune --preset eurosat64 --ckpt
logs/run/best --dataset clouds --lora_rank 8 --steps 2000``

``--method lora`` (default) trains low-rank deltas on the kernel leaves
(``train/lora.py``) of a frozen checkpoint; ``cli.inference --lora <dir>``
merges them at load. ``--method controlnet`` trains a zero-init encoder-copy
branch (``models/controlnet.py``, arXiv:2302.05543) that adds a new
conditioning stream, the hint image, to a frozen unconditional checkpoint;
``cli.inference --controlnet <dir>`` serves it. Both train only the adapter
(its share of the base is printed), with AdamW (weight decay 1e-4, as
``optax.adamw``) under optax's warmup-cosine table (``steps // 20`` warmup,
down to 1 % of ``--lr``), leave the base checkpoint untouched and write the
JAX package's files: ``lora.npz`` (``"<keystr>::a"`` / ``"<keystr>::b"``,
the flax view) + ``lora.json``, or ``controlnet.npz`` + ``controlnet.json``,
so an adapter trained by either package loads in the other.

The base is a port checkpoint of ``cli.train`` (its EMA weights unless
``--use_raw_params``). Runs on the GPU (``--device cuda``, the default) and
exits non-zero when there is none; ``--device cpu`` runs on the CPU. In a
LoRA step every adapted 3x3 conv takes the weight-gradient kernel on its
merged weight; in a ControlNet step the frozen base's convs take none.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np
import torch

from eo_diffusion_torch.cli.common import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="adapter fine-tuning (PyTorch/CUDA)")
    p.add_argument("--method", type=str, default="lora", choices=["lora", "controlnet"],
                   help="lora = low-rank weight deltas; controlnet = zero-init encoder-copy "
                        "branch adding a new conditioning stream (the hint image) to a frozen "
                        "checkpoint")
    p.add_argument("--hint_source", type=str, default="auto",
                   choices=["auto", "cond_image", "gray"],
                   help="controlnet hint per batch: the dataset's paired cond_image view, or a "
                        "grayscale of the target (auto = cond_image when present)")
    p.add_argument("--preset", type=str, default="eurosat64")
    p.add_argument("--ckpt", type=str, required=True,
                   help="the base checkpoint (cli.train's logs/<run>/<name>)")
    p.add_argument("--dataset", type=str, default=None,
                   help="target-domain dataset (default: the preset's)")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=8.0)
    p.add_argument("--targets", type=str, nargs="*", default=None,
                   help="path substrings selecting which kernels get adapters (default: all "
                        "2-D/4-D kernels)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-3,
                   help="adapter LR (adapters tolerate ~10x the full-weights LR)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--dir", type=str, default="results/lora")
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_bf16", action="store_true")
    p.add_argument("--use_raw_params", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; never falls back silently")
    return p.parse_args(argv)


def save_lora(outdir: str, lora, meta: dict) -> None:
    """``lora.npz`` (``"<keystr>::a"`` / ``"::b"``, float32, the flax view)
    and ``lora.json`` under ``outdir`` (JAX ``save_lora``)."""
    flat = {}
    for path, ab in lora.items():
        flat[path + "::a"] = ab["a"].detach().float().cpu().numpy()
        flat[path + "::b"] = ab["b"].detach().float().cpu().numpy()
    os.makedirs(outdir, exist_ok=True)
    np.savez(os.path.join(outdir, "lora.npz"), **flat)
    with open(os.path.join(outdir, "lora.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_lora(path: str):
    """``(adapters, meta)`` from a finetune ``--dir`` (or a ``lora.npz``
    path): ``{keystr: {"a", "b"}}`` as float32 CPU tensors, and the
    ``lora.json`` beside it ({} if none)."""
    npz = path if path.endswith(".npz") else os.path.join(path, "lora.npz")
    meta_path = os.path.join(os.path.dirname(npz), "lora.json")
    data = np.load(npz)
    lora = {}
    for k in data.files:
        p, part = k.rsplit("::", 1)
        lora.setdefault(p, {})[part] = torch.from_numpy(np.array(data[k], np.float32))
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return lora, meta


def _batch_hint(batch, source: str) -> np.ndarray:
    """The ControlNet branch's hint for one batch (numpy, NHWC): the paired
    ``cond_image`` view, or the target's grayscale."""
    if source in ("auto", "cond_image") and "cond_image" in batch:
        return np.asarray(batch["cond_image"], np.float32)
    assert source != "cond_image", (
        "--hint_source cond_image: the dataset supplies no paired view")
    img = np.asarray(batch["image"], np.float32)
    return img.mean(axis=-1, keepdims=True)


def _setup(args, with_hint: bool):
    """The preset, the process, the frozen base on the device and the
    training loader, as both methods need them."""
    from eo_diffusion_torch.cli.presets import build_denoiser, build_process, get_preset
    from eo_diffusion_torch.data.factories import DATASET_FACTORIES
    from eo_diffusion_torch.weights import load_reference_checkpoint

    device = resolve_device(args.device, "eo_diffusion_torch.cli.finetune")
    preset = get_preset(args.preset)
    if args.method == "controlnet":
        assert preset.backbone == "unet" and not preset.is_latent, (
            "ControlNet adapters are wired for pixel-space UNet presets")
    else:
        assert not preset.is_latent, (
            "LoRA fine-tuning is wired for pixel-space presets (adapt the denoiser; the first "
            "stage is frozen anyway)")
    if args.image_size:
        preset.image_size = args.image_size
    batch_size = args.batch_size or preset.batch_size
    dataset = args.dataset or preset.dataset
    diffusion = build_process(preset, preset.timesteps, preset.image_size, cond_type=None)
    mcfg = preset.model_config(bf16=not args.no_bf16)
    base = build_denoiser(mcfg)
    base.load_state_dict(load_reference_checkpoint(args.ckpt, mcfg,
                                                   use_ema=not args.use_raw_params), strict=True)
    base = base.to(device).requires_grad_(False).eval()
    fkw = dict(batch_size=batch_size)
    if args.data_root:
        fkw["root"] = args.data_root
    if dataset == "synthetic":
        fkw["image_size"] = preset.image_size
        fkw["channels"] = preset.in_channels
        if with_hint and args.hint_source in ("auto", "cond_image"):
            fkw["with_cond_image"] = True
    train_loader, _ = DATASET_FACTORIES[dataset](**fkw)
    return device, preset, mcfg, diffusion, base, train_loader, dataset


def _batches(loader):
    """The loader's batches, cycled."""
    while True:
        yield from loader


def _train(args, module, loss_fn, batches, device):
    """``args.steps`` AdamW steps of ``loss_fn(batch, generator)`` on
    ``module``'s parameters under the warmup-cosine table (``cli.distill``'s
    loop). Returns ``(losses, step_seconds, steps_per_s)``."""
    from eo_diffusion_torch.cli.distill import _fit, _timing

    gen = torch.Generator(device=device).manual_seed(args.seed)
    _, losses, seconds = _fit(args, module, lambda i: loss_fn(next(batches), gen))
    print(f"fine-tuned: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    return losses, seconds, _timing(seconds)["steps_per_s"]


def main_controlnet(args):
    from eo_diffusion_torch.models.controlnet import (ControlNet, control_param_count,
                                                      init_from_base, save_controlnet)

    device, preset, mcfg, diffusion, base, loader, dataset = _setup(args, with_hint=True)
    n_base = sum(p.numel() for p in base.parameters())
    batches = _batches(loader)
    first = next(batches)
    hint_ch = _batch_hint(first, args.hint_source).shape[-1]
    torch.manual_seed(args.seed)  # the branch's fresh leaves (hint encoder, zero heads)
    cnet = ControlNet(mcfg, hint_channels=hint_ch)
    n_copied = init_from_base(cnet, base)
    cnet = cnet.to(device).train()
    n_ctrl = control_param_count(cnet)
    print(f"ControlNet: {n_copied} encoder tensors copied from base, {n_ctrl / 1e6:.2f}M "
          f"adapter params ({100.0 * n_ctrl / n_base:.1f}% of {n_base / 1e6:.2f}M base), "
          f"hint_channels={hint_ch}")
    to_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    fn = lambda x, t, c, y: base(x, t, y=y, control=cnet(x, t, c, y=y))

    def loss_fn(batch, gen):
        return diffusion.train_loss(fn, to_dev(batch["image"]), generator=gen,
                                    cond=to_dev(_batch_hint(batch, args.hint_source)))

    losses, seconds, sps = _train(args, cnet, loss_fn, itertools.chain([first], batches),
                                  device)
    save_controlnet(args.dir, cnet, {
        "preset": args.preset, "hint_channels": hint_ch, "hint_source": args.hint_source,
        "base_ckpt": os.path.abspath(args.ckpt), "dataset": dataset, "steps": args.steps,
        "n_ctrl_params": n_ctrl, "n_base_params": n_base,
        "loss_first": losses[0], "loss_last": losses[-1]})
    print(f"adapter saved to {args.dir} (controlnet.npz + controlnet.json)")
    return {"loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
            "n_ctrl": n_ctrl, "step_seconds": seconds, "steps_per_s": sps,
            "controlnet": cnet, "base": base}


def main(args):
    """Fine-tune an adapter for ``args.steps`` steps and save it under
    ``args.dir``. Returns the first and last loss, every loss, the adapter's
    parameter count, the host seconds of every step and the steps/s after
    the first two."""
    if args.method == "controlnet":
        return main_controlnet(args)
    from torch.func import functional_call

    from eo_diffusion_torch.train.lora import (lora_init, lora_param_count, lora_targets,
                                               merged_parameters)

    device, preset, mcfg, diffusion, base, loader, dataset = _setup(args, with_hint=False)
    n_base = sum(p.numel() for p in base.parameters())
    targets = lora_targets(base, args.targets)
    lora = lora_init(base, rank=args.lora_rank, match=args.targets,
                     generator=torch.Generator().manual_seed(args.seed))
    n_lora = lora_param_count(lora)
    print(f"LoRA: {len(lora)} adapted kernels, {n_lora / 1e3:.1f}k adapter params "
          f"({100.0 * n_lora / n_base:.2f}% of {n_base / 1e6:.2f}M base)")
    to_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)

    def loss_fn(batch, gen):
        merged = merged_parameters(base, lora, alpha=args.lora_alpha, targets=targets)
        fn = lambda x, t, c, y: functional_call(base, merged, (x, t), {"cond": c, "y": y})
        return diffusion.train_loss(fn, to_dev(batch["image"]), generator=gen)

    losses, seconds, sps = _train(
        args, torch.nn.ParameterList(v for ab in lora.values() for v in ab.values()), loss_fn,
        _batches(loader), device)
    save_lora(args.dir, lora, {
        "preset": args.preset, "rank": args.lora_rank, "alpha": args.lora_alpha,
        "targets": args.targets, "base_ckpt": os.path.abspath(args.ckpt), "dataset": dataset,
        "steps": args.steps, "n_lora_params": n_lora, "n_base_params": n_base,
        "loss_first": losses[0], "loss_last": losses[-1]})
    print(f"adapter saved to {args.dir} (lora.npz + lora.json)")
    return {"loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
            "n_lora": n_lora, "step_seconds": seconds, "steps_per_s": sps,
            "lora": lora, "base": base}


if __name__ == "__main__":
    main(parse_args())
