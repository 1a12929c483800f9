"""Training CLI of the port (the main-path flags of ``eo_diffusion_tpu.cli.train``).

``python -m eo_diffusion_torch.cli.train --preset sen12mscr256 --dataset
sen12mscr --data_root /data/SEN12MS_CR --batch_size 8 --epochs 100``

Runs on the GPU (``--device cuda``, the default) and exits non-zero when
there is none; the CPU is used only with ``--device cpu``. Flags mirror
reference ``train.py:22-42`` plus the preset/dataset selectors. Like the JAX
CLI it reads any dataset of ``DATASET_FACTORIES`` (``--dataset``, from
``--data_root``), feeding the batches to the device through
``device_prefetch``, and writes periodic EMA previews as PNG grids
(train.py:148-154), a ``best`` checkpoint whenever the loss improves on
the bar (from 0.9 down, train.py:100,133-155) and periodic ``steps_<n>``
checkpoints under ``logs/<basename of --dir>``; ``--resume`` continues the step counter, the
LR schedule and the EMA cadence; SIGTERM finishes the step in flight,
checkpoints and exits. Every UNet and DiT preset of the port trains, with the
DDPM chain or rectified flow (``dit256``, ``flow64``, ``tiny-dit``,
``tiny-flow``, ...); a flow preset previews with ``--preview_sampler flow``,
which it forces. ``--wandb`` logs the loss, the LR and the previews to
Weights & Biases when the package is installed, and prints a line and logs
to stdout only when it is not. Flags of the JAX CLI that later slices of the
port bring are rejected by name with their ROADMAP queue.
"""

from __future__ import annotations

import argparse
import itertools
import math
import os
import signal
import time

import numpy as np
import torch

# flags of the JAX training CLI that are not ported yet -> ROADMAP queue
UNPORTED_FLAGS = {
    "--ae_ckpt": 10, "--ae_steps": 10, "--ae_lr": 10,
    "--posthoc_ema": 11, "--posthoc_gammas": 11, "--model_base_dim": 11,
    "--tome_ratio": 13, "--tome_mlp": 13, "--optimizer": 14, "--muon_lr_mult": 14,
    "--config": 14, "--fsdp": 16, "--tp": 16, "--sp": 16, "--ep": 16,
    "--model_parallel": 16, "--pp_micro": 16, "--pp_virtual": 16,
    "--profile_dir": 17, "--profile_steps": 17,
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train EO diffusion (PyTorch/CUDA)")
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--dir", type=str, default="results/run", help="sample output directory")
    parser.add_argument("--ckpt", type=str, default="", help="checkpoint path to resume from")
    parser.add_argument("--resume", action="store_true",
                        help="auto-resume from the latest checkpoint in the run's "
                             "log dir if one exists (restart-safe training)")
    parser.add_argument("--n_samples", type=int, default=16)
    parser.add_argument("--timesteps", type=int, default=None)
    parser.add_argument("--model_ema_steps", type=int, default=10)
    parser.add_argument("--model_ema_decay", type=float, default=0.995)
    parser.add_argument("--log_freq", type=int, default=10)
    parser.add_argument("--no_clip", action="store_true")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--num_classes", type=int, default=0)
    parser.add_argument("--class_dropout", type=float, default=0.0,
                        help="CFG label-dropout probability (reserves the "
                             "learned null-class row)")
    parser.add_argument("--cond_type", type=str, default=None)
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="accumulate gradients over k micro-batches per "
                             "optimizer step (lucidrains gradient_accumulate_every)")
    parser.add_argument("--grad_clip", type=float, default=0.0,
                        help="global-norm gradient clipping (0 = off; "
                             "recommended ~1.0 for small micro-batches at "
                             "high resolution, e.g. the 256px presets)")
    parser.add_argument("--skip_nonfinite", action="store_true",
                        help="drop updates with non-finite grads (params/opt "
                             "state untouched; count in the step metrics) "
                             "instead of poisoning the run")
    parser.add_argument("--preset", type=str, default="eurosat64")
    parser.add_argument("--dataset", type=str, default=None, help="override preset dataset")
    parser.add_argument("--data_root", type=str, default=None,
                        help="the dataset's root directory (the factory's root=)")
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--steps_per_epoch", type=int, default=None,
                        help="cap steps per epoch (smoke runs)")
    parser.add_argument("--no_bf16", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sample_every", type=int, default=1000)
    parser.add_argument("--save_every", type=int, default=1000)
    parser.add_argument("--preview_sampler", type=str, default="ddpm",
                        choices=["ddpm", "ddim", "flow"],
                        help="sampler for the periodic training previews "
                             "(ddpm = reference parity, full T-step chain; "
                             "flow = the ODE of flow-process presets, which force it)")
    parser.add_argument("--preview_steps", type=int, default=50,
                        help="steps for ddim previews")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; never falls back silently")
    for arg in (argv if argv is not None else __import__("sys").argv[1:]):
        flag = arg.split("=")[0]
        if flag in UNPORTED_FLAGS:
            parser.error(f"{flag} is not ported yet (ROADMAP queue {UNPORTED_FLAGS[flag]})")
    return parser.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("eo_diffusion_torch.cli.train: no CUDA device is "
                         "available; pass --device cpu to train on the CPU")
    return device


def _to_model_batch(batch, cond_type):
    """Build the model batch dict.

    * cond_type="sum": cond = (image | 1-mask) channel-concat like the
      reference's inference.py:101,109 -- used at sampling time only.
    * cond_type="concat": cond is the dataset's paired conditioning image
      ("cond_image", e.g. the cloudy SEN12MS-CR view), or (image | mask)
      when only a segmentation is available.
    """
    out = {"image": batch["image"]}
    if cond_type == "sum" and "segmentation" in batch:
        out["cond"] = np.concatenate([batch["image"], 1.0 - batch["segmentation"]], axis=-1)
    elif cond_type == "concat":
        if "cond_image" in batch:
            out["cond"] = batch["cond_image"]
        elif "segmentation" in batch:
            out["cond"] = np.concatenate([batch["image"], batch["segmentation"]], axis=-1)
    if "class" in batch:
        out["label"] = batch["class"]
    return out


def main(args):
    """Train for ``args.epochs`` epochs. Returns a summary dict: the steps
    taken, every step's loss and host-clock seconds (each ends in a fetch of
    the loss), the host-clock seconds each step waited for its batch from the
    feed before it, the seconds of the timed loop, the path of the last
    checkpoint and the final train state."""
    from eo_diffusion_torch.cli.presets import build_denoiser, build_process, get_preset
    from eo_diffusion_torch.data.factories import DATASET_FACTORIES
    from eo_diffusion_torch.data.loader import device_prefetch
    from eo_diffusion_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                                     save_checkpoint)
    from eo_diffusion_torch.train.trainer import Trainer, TrainerConfig
    from eo_diffusion_torch.utils.images import save_image_grid

    device = resolve_device(args.device)
    preset = get_preset(args.preset)
    # flow presets preview by ODE integration; the DDPM chain has no ODE
    # integrator, so fail before the first preview hours in
    if args.preview_sampler == "flow" and preset.process != "flow":
        raise SystemExit(f"--preview_sampler flow requires a flow-process preset; "
                         f"{preset.name} trains the DDPM chain (use ddpm/ddim)")
    preview_sampler = "flow" if preset.process == "flow" else args.preview_sampler
    dataset = args.dataset or preset.dataset
    factory = DATASET_FACTORIES[dataset]
    image_size = args.image_size or preset.image_size
    preset.image_size = image_size
    timesteps = args.timesteps or preset.timesteps
    cond_type = args.cond_type or preset.cond_type
    if cond_type not in (None, "sum", "concat"):
        raise NotImplementedError(f"--cond_type {cond_type} is not ported yet "
                                  "(ROADMAP queue 13)")
    if args.num_classes == 0 and preset.num_classes:
        args.num_classes = preset.num_classes
    num_classes = args.num_classes if args.num_classes > 0 else None
    ckpt_dir = os.path.join("logs", os.path.split(args.dir)[1])

    fkw = dict(batch_size=args.batch_size)
    if args.data_root:
        fkw["root"] = args.data_root
    if dataset == "synthetic":
        fkw["image_size"] = image_size
        fkw["channels"] = preset.in_channels
        if cond_type == "concat":
            fkw["with_cond_image"] = True  # synthetic cloudy view as cond
    train_loader, _ = factory(**fkw)
    steps_per_epoch = len(train_loader)
    if args.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
    data_range = train_loader.dataset.data_range

    # "sum" (RePaint) conditions at sampling time only (model.py:52): the
    # UNet stays unconditional. "concat" feeds the dataset's cond channels in.
    peek = {k: np.asarray(v)[None] for k, v in train_loader.dataset[0].items()}
    batch0 = _to_model_batch(peek, cond_type)
    has_cond = cond_type == "concat" and "cond" in batch0
    cond_channels = batch0["cond"].shape[-1] if has_cond else 0
    torch.manual_seed(args.seed)  # the model's initial weights
    model = build_denoiser(preset.model_config(
        bf16=not args.no_bf16, cond_channels=cond_channels, num_classes=num_classes,
        class_dropout_prob=args.class_dropout))
    diffusion = build_process(preset, timesteps, image_size, cond_type=cond_type)

    tcfg = TrainerConfig(
        lr=args.lr, batch_size=args.batch_size, epochs=args.epochs, timesteps=timesteps,
        model_ema_steps=args.model_ema_steps, model_ema_decay=args.model_ema_decay,
        log_freq=args.log_freq, n_samples=args.n_samples, no_clip=args.no_clip,
        num_classes=args.num_classes, cond_type=cond_type, ckpt_dir=ckpt_dir,
        sample_dir=args.dir, seed=args.seed, grad_accum=args.grad_accum,
        grad_clip=args.grad_clip, skip_nonfinite=args.skip_nonfinite,
        preview_sampler=preview_sampler, preview_steps=args.preview_steps)
    trainer = Trainer(tcfg, model, diffusion, steps_per_epoch, device=device)
    state = trainer.init()
    n_params = sum(p.numel() for p in state.params)
    print(f"Diffusion with {n_params / 1e6} M params on {device}")

    ckpt_path = args.ckpt
    if not ckpt_path and args.resume:
        last = latest_step(tcfg.ckpt_dir)
        if last is not None:
            ckpt_path = os.path.join(tcfg.ckpt_dir, f"steps_{last:08d}")
            print(f"auto-resume: found {ckpt_path}")
    if ckpt_path:
        print("Loading checkpoint...")
        state = restore_checkpoint(ckpt_path, state)
        print(f"loaded! resuming from step {state.step}")

    run = None
    if args.wandb:
        try:
            import wandb

            run = wandb.init(project="EO-minimal-diffusion")
        except Exception as e:  # offline env: degrade to prints
            print(f"wandb unavailable ({e}); logging to stdout only")

    os.makedirs(args.dir, exist_ok=True)
    os.makedirs(tcfg.ckpt_dir, exist_ok=True)

    best_loss = 0.9  # same initial bar as the reference (train.py:100)
    # resume continues the step counter (and thus the LR schedule/EMA cadence)
    global_steps = state.step
    y_test = np.full((args.n_samples,), 1) if args.num_classes > 0 else None

    # preemption-safe shutdown: schedulers deliver SIGTERM with a grace window
    # before reclaiming the host -- mark the flag, finish the in-flight step,
    # checkpoint, and exit cleanly so --resume continues from the exact step
    preempt = {"sig": None}

    def _graceful(signum, frame):  # noqa: ANN001 (signal API)
        preempt["sig"] = signum

    old_term = signal.signal(signal.SIGTERM, _graceful)

    losses, step_seconds, wait_seconds = [], [], []
    t_start = time.time()
    start_epoch = min(global_steps // steps_per_epoch, args.epochs)
    for epoch in range(start_epoch, args.epochs):
        if preempt["sig"] is not None:
            break
        feed = device_prefetch((_to_model_batch(b, cond_type) for b in
                                itertools.islice(train_loader, steps_per_epoch)), device)
        t_wait = time.perf_counter()
        for j, mb in enumerate(feed):
            if preempt["sig"] is not None:
                break
            t_step = time.perf_counter()
            wait_seconds.append(t_step - t_wait)  # the feed's share of the step
            state, metrics = trainer.step(state, mb)
            global_steps += 1
            loss = float(metrics["loss"])  # host fetch: the step really ran
            step_seconds.append(time.perf_counter() - t_step)
            losses.append(loss)
            lr = trainer.current_lr(global_steps - 1)
            if args.log_freq and j % args.log_freq == 0:
                print("Epoch[{}/{}],Step[{}/{}],loss:{:.5f},lr:{:.5f}".format(
                    epoch + 1, args.epochs, j, steps_per_epoch, loss, lr))
            if run is not None:
                run.log({"loss": loss, "lr": lr})

            if loss < best_loss:
                best_loss = loss
                save_checkpoint(tcfg.ckpt_dir, state.state_dict(), name="best")

            # sample_every=0 disables periodic previews entirely
            if args.sample_every and global_steps % args.sample_every == 0:
                cond = mb.get("cond")
                cond = cond[: args.n_samples] if cond is not None else None
                # conditioned previews can't exceed the cond rows available
                # from the current micro-batch
                n_prev = min(args.n_samples, len(cond)) if cond is not None else args.n_samples
                samples = trainer.sample(
                    state, global_steps, n=n_prev, cond=cond,
                    y=None if y_test is None else np.asarray(y_test)[:n_prev])
                img_path = os.path.join(args.dir, f"steps_{global_steps:08d}.png")
                nrow = max(int(math.sqrt(n_prev)), 1)
                save_image_grid(samples.float().cpu().numpy(), img_path, nrow=nrow,
                                data_range=data_range)
                print(f"saving in {img_path}, epoch {epoch}")
                if run is not None:
                    # wandb sample galleries (reference ddpm.py:502-539 log_images)
                    import wandb

                    run.log({"samples": wandb.Image(img_path)})
                if cond is not None:
                    save_image_grid(
                        cond[..., :3].float().cpu().numpy(),
                        os.path.join(args.dir, f"steps_{global_steps:08d}_cond.png"),
                        nrow=nrow, data_range=data_range)
            if args.save_every and global_steps % args.save_every == 0:
                save_checkpoint(tcfg.ckpt_dir, state.state_dict(), step=global_steps)
            t_wait = time.perf_counter()

    signal.signal(signal.SIGTERM, old_term)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t_start
    last_ckpt = save_checkpoint(tcfg.ckpt_dir, state.state_dict(), step=global_steps)
    result = {"steps": global_steps, "losses": losses, "seconds": dt,
              "step_seconds": step_seconds, "wait_seconds": wait_seconds,
              "checkpoint": last_ckpt, "state": state, "preempted": preempt["sig"]}
    if preempt["sig"] is not None:
        print(f"preempted (signal {preempt['sig']}): checkpoint saved at "
              f"step {global_steps}; rerun with --resume to continue")
        return result
    print(f"done: {global_steps} steps in {dt:.1f}s ({global_steps / max(dt, 1e-9):.2f} steps/s)")
    return result


if __name__ == "__main__":
    main(parse_args())
