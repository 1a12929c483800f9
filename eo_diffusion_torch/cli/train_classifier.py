"""Noisy-image classifier training for classifier-guided sampling (the port
of ``eo_diffusion_tpu.cli.train_classifier``).

``python -m eo_diffusion_torch.cli.train_classifier --preset synthetic64
--class_correlated --steps 2000 --dir results/classifier``

Trains the :class:`~eo_diffusion_torch.models.encoder_unet.EncoderUNet`
(reference ``EncoderUNetModel``, backbones/unet.py:845+) on q-sampled noisy
images with t uniform over the preset's whole range (Dhariwal & Nichol
2021: sampling queries the classifier along the whole reverse trajectory),
with AdamW (weight decay 1e-4 on every parameter, as ``optax.adamw``) under
optax's warmup-cosine schedule (a linear warmup from 0 over ``steps // 20``
steps, then a cosine decay to ``lr / 100``). It reports the held-out
accuracy at ``t0`` (t = 0), ``t_mid`` (T/2) and ``t_hi`` (0.8 T), and
writes ``<dir>/classifier`` (a ``train.checkpoint`` file: the classifier's
state dict as ``"model"`` and ``"model_ema"``) and ``<dir>/classifier.json``.
Serve it with ``cli.inference --classifier_ckpt <dir> --classifier_scale s``.

Runs on the GPU (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` trains on the CPU. The classifier computes in
float32, as the JAX package's does; on the card its attention runs the
attention kernels with the row logsumexp and their backward, and its norms
the GroupNorm kernels both ways.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from eo_diffusion_torch.cli.common import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Noisy-image classifier training (PyTorch/CUDA)")
    p.add_argument("--preset", type=str, default="synthetic64",
                   help="preset supplying image grid + diffusion schedule (the classifier "
                        "must match the model it will guide)")
    p.add_argument("--dir", type=str, default="results/classifier")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_classes", type=int, default=None,
                   help="label vocabulary (default: dataset metadata, or 5 for the synthetic "
                        "fixture)")
    p.add_argument("--class_correlated", action="store_true",
                   help="synthetic dataset: correlate image content with the label so the "
                        "classifier has real signal")
    p.add_argument("--eval_n", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; never falls back silently")
    return p.parse_args(argv)


def build_classifier(preset, num_classes):
    """EncoderUNet sized like the preset's denoiser torso."""
    from eo_diffusion_torch.models.encoder_unet import EncoderUNet, EncoderUNetConfig

    assert not preset.is_latent, (
        "the classifier reads pixels (guidance runs in the sampler's space); latent-space "
        "guidance is not wired")
    return EncoderUNet(EncoderUNetConfig(
        image_size=preset.image_size,
        in_channels=preset.in_channels,
        model_channels=preset.base_dim,
        num_classes=num_classes,
        num_res_blocks=max(preset.num_res_blocks, 1),
        attention_resolutions=preset.attention_resolutions,
        channel_mult=preset.dim_mults or (1, 2),
        num_heads=max(preset.num_heads, 1),
    ))


def load_classifier(ckpt_dir: str, device) -> tuple:
    """``(classifier, meta)`` from a directory this CLI wrote: the EncoderUNet
    on ``device``, in eval mode, its parameters frozen (a guided sampler
    needs only the input gradient)."""
    from eo_diffusion_torch.cli.presets import get_preset
    from eo_diffusion_torch.train.checkpoint import restore_params

    with open(os.path.join(ckpt_dir, "classifier.json")) as f:
        meta = json.load(f)
    model = build_classifier(get_preset(meta["preset"]), int(meta["num_classes"]))
    model.load_state_dict(restore_params(os.path.join(ckpt_dir, "classifier"))[1],
                          strict=True)
    return model.to(device).eval().requires_grad_(False), meta


def _synthetic_loaders(preset, batch_size, class_correlated, seed):
    from eo_diffusion_torch.data.datasets import SyntheticEO, train_val_split
    from eo_diffusion_torch.data.loader import DataLoader

    ds = SyntheticEO(size=preset.image_size, length=1024, channels=preset.in_channels,
                     num_classes=5, class_correlated=class_correlated,
                     data_range=(-1.0, 1.0), seed=seed)
    tr, te = train_val_split(ds, 0.15, 4097)
    return (DataLoader(tr, batch_size, shuffle=True, seed=seed),
            DataLoader(te, batch_size, shuffle=False, drop_last=False))


def _nll_acc(model, x_t, y, t):
    logits = model(x_t, t)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, y[:, None]).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return nll, acc


def main(args):
    """Train, evaluate and save. Returns the metadata written to
    ``classifier.json`` plus ``steps_per_s``: the rate of the steps after the
    first (which pays cuDNN's first calls), synchronised at both ends."""
    from eo_diffusion_torch.cli.presets import get_preset
    from eo_diffusion_torch.data.datasets import get_metadata
    from eo_diffusion_torch.data.factories import DATASET_FACTORIES
    from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
    from eo_diffusion_torch.train.checkpoint import save_checkpoint
    from eo_diffusion_torch.train.lr_schedules import set_lr, warmup_cosine_decay

    device = resolve_device(args.device, "eo_diffusion_torch.cli.train_classifier")
    preset = get_preset(args.preset)
    assert preset.process == "ddpm", (
        f"classifier guidance steers the DDPM chain; preset {preset.name} trains "
        f"{preset.process}")
    batch_size = args.batch_size or preset.batch_size
    if args.num_classes:
        num_classes = args.num_classes
    elif preset.dataset == "synthetic":
        num_classes = 5
    else:
        num_classes = get_metadata(preset.dataset)["num_classes"]
    if preset.dataset == "synthetic":
        train_loader, test_loader = _synthetic_loaders(preset, batch_size,
                                                       args.class_correlated, args.seed)
    else:
        train_loader, test_loader = DATASET_FACTORIES[preset.dataset](batch_size=batch_size)

    diffusion = GaussianDiffusion.create(timesteps=preset.timesteps,
                                         image_size=preset.image_size,
                                         in_channels=preset.in_channels)
    torch.manual_seed(args.seed)  # the classifier's initial weights
    model = build_classifier(preset, num_classes).to(device).train()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"classifier with {n_params / 1e6:.2f} M params, {num_classes} classes on {device}")

    table = warmup_cosine_decay(0.0, args.lr, max(args.steps // 20, 1), args.steps,
                                args.lr * 0.01)
    opt = torch.optim.AdamW(model.parameters(), lr=float(table[0]), betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    T = diffusion.timesteps
    it = iter(train_loader)
    loss = acc = None
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    t0 = t1 = time.perf_counter()
    for i in range(args.steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(train_loader)
            batch = next(it)
        x = torch.as_tensor(np.asarray(batch["image"], np.float32), device=device)
        y = torch.as_tensor(np.asarray(batch["class"]), dtype=torch.long, device=device)
        t = torch.randint(0, T, (x.shape[0],), generator=gen, device=device)
        eps = torch.randn(x.shape, generator=gen, device=device)
        l, a = _nll_acc(model, diffusion.q_sample(x, t, eps), y, t)
        set_lr(opt, table, i)
        opt.zero_grad(set_to_none=True)
        l.backward()
        opt.step()
        if i == 0:
            sync()
            t1 = time.perf_counter()
        if (i + 1) % max(args.steps // 10, 1) == 0:
            loss, acc = float(l.detach()), float(a)
            print(f"step {i + 1}/{args.steps} loss={loss:.4f} acc={acc:.3f} "
                  f"({(time.perf_counter() - t0) / (i + 1) * 1e3:.0f} ms/step)")
    sync()
    steps_per_s = (args.steps - 1) / max(time.perf_counter() - t1, 1e-9)
    print(f"{steps_per_s:.4f} steps/s after the first step")

    # accuracy at three noise levels on held-out data (guidance quality is
    # set by mid-trajectory accuracy, not clean accuracy)
    model.eval()
    xs, ys = [], []
    for batch in test_loader:
        xs.append(np.asarray(batch["image"], np.float32))
        ys.append(np.asarray(batch["class"]))
        if sum(len(b) for b in xs) >= args.eval_n:
            break
    x_ev = torch.as_tensor(np.concatenate(xs)[: args.eval_n], device=device)
    y_ev = torch.as_tensor(np.concatenate(ys)[: args.eval_n], dtype=torch.long, device=device)
    eps = torch.randn(x_ev.shape, generator=torch.Generator(device=device).manual_seed(7),
                      device=device)
    eval_acc = {}
    with torch.no_grad():
        for name, tv in {"t0": 0, "t_mid": T // 2, "t_hi": int(T * 0.8)}.items():
            t = torch.full((x_ev.shape[0],), tv, dtype=torch.long, device=device)
            eval_acc[name] = float(_nll_acc(model, diffusion.q_sample(x_ev, t, eps),
                                            y_ev, t)[1])
    print("eval accuracy:", json.dumps(eval_acc))

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    ckpt_path = save_checkpoint(args.dir, {"model": sd, "model_ema": sd, "step": args.steps},
                                name="classifier")
    meta = {"preset": preset.name, "num_classes": num_classes, "steps": args.steps,
            "final_loss": loss, "final_acc": acc, "eval_acc": eval_acc}
    with open(os.path.join(args.dir, "classifier.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(f"classifier checkpoint: {ckpt_path}")
    return dict(meta, steps_per_s=steps_per_s)


if __name__ == "__main__":
    main(parse_args())
