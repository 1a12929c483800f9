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
DDPM chain, rectified flow (``dit256``, ``flow64``, ``tiny-dit``,
``tiny-flow``, ...), EDM (``edm64``, ``tiny-edm``, ``tiny-dit-edm``) or the
Brownian bridge (``bridge64``, ``tiny-bridge``, ``tiny-latent-bridge``, on
paired data: the concat cond is the bridge's source) or MeanFlow
(``meanflow64``, ``cmeanflow64``, ``tiny-meanflow``, ``tiny-cmeanflow``,
``tiny-dit-meanflow``: a dual-time backbone with plain attention, its loss a
``torch.func.jvp`` through the model; a CFG-integrated preset's label dropout
defaults to 0.1 and belongs to the loss); a flow, EDM, bridge or MeanFlow
preset previews with its process's own sampler (``--preview_sampler flow``,
which it forces). A latent preset (``latent256-cr``, ``tiny-latent``, ...)
first loads its float32 first stage from ``<ckpt dir>/ae`` or ``--ae_ckpt``,
or trains it for ``--ae_steps`` on the train split's images and saves it
there, then trains the denoiser on the encoded grid (the concat cond
encoded too); its previews decode to pixels. ``--wandb`` logs the loss, the
LR and the previews to Weights & Biases when the package is installed, and
prints a line and logs to stdout only when it is not. ``--posthoc_ema`` keeps
power-function EMA tracks beside the EMA and snapshots them under
``<ckpt dir>/phema`` at every ``--save_every`` and at the end, for the
sampling CLI's ``--phema_sigma_rel`` and ``--autoguide_sigma_rel``. Flags of
the JAX CLI that later slices of the port bring are rejected by name with
their ROADMAP queue.
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

from eo_diffusion_torch.cli.common import resolve_device

# flags of the JAX training CLI that are not ported yet -> ROADMAP queue
UNPORTED_FLAGS = {
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
    parser.add_argument("--model_base_dim", type=int, default=None,
                        help="the backbone's base width (UNet channels, DiT hidden size)")
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
                        choices=["ddpm", "ddim", "dpm", "flow"],
                        help="sampler for the periodic training previews "
                             "(ddpm = reference parity, full T-step chain; ddim/dpm "
                             "--preview_steps steps; flow = the ODE of flow-process "
                             "presets, which force it)")
    parser.add_argument("--posthoc_ema", action="store_true",
                        help="keep power-function EMA tracks (arXiv:2312.02696) beside "
                             "the EMA and snapshot them at every --save_every under "
                             "<ckpt dir>/phema; the sampling CLI synthesizes any EMA "
                             "length from them (--phema_sigma_rel)")
    parser.add_argument("--posthoc_gammas", type=str, default="16.97,6.94",
                        help="comma-separated power-EMA exponents (the defaults are "
                             "sigma_rel 0.05 and 0.10)")
    parser.add_argument("--preview_steps", type=int, default=50,
                        help="steps for ddim previews")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; never falls back silently")
    parser.add_argument("--ae_ckpt", type=str, default=None,
                        help="latent presets: directory of a trained first stage "
                             "(train/ae_trainer.save_ae layout); default <ckpt dir>/ae, "
                             "trained there when missing")
    parser.add_argument("--ae_steps", type=int, default=None,
                        help="latent presets: first-stage training steps when no saved "
                             "first stage exists (default: preset.ae_steps)")
    parser.add_argument("--ae_lr", type=float, default=2e-3)
    for arg in (argv if argv is not None else __import__("sys").argv[1:]):
        flag = arg.split("=")[0]
        if flag in UNPORTED_FLAGS:
            parser.error(f"{flag} is not ported yet (ROADMAP queue {UNPORTED_FLAGS[flag]})")
    return parser.parse_args(argv)


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


class _ImageBatches:
    """Re-iterable image-batch view of a loader (the AE trainer cycles it)."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        for b in self.loader:
            yield np.asarray(b["image"], np.float32)


def _latent_first_stage(args, preset, inner, train_loader, ckpt_dir, cond_type, device):
    """Acquire the first stage (load it, or train and save it) and wrap the
    inner process: ``(LatentDiffusion, info)``. The reference receives its
    first stage pre-trained (ddpm.py:628-645); with none available, a latent
    preset trains a small ConvAutoencoder on the target dataset once and keeps
    it under ``<ckpt_dir>/ae``. ``info``: the directory, and for a trained
    one its steps, host seconds a step and scale factor."""
    from eo_diffusion_torch.models.autoencoder import ConvAutoencoder
    from eo_diffusion_torch.train import ae_trainer as AET

    ae_dir = args.ae_ckpt or os.path.join(ckpt_dir, "ae")
    info = {"dir": ae_dir, "trained": False}
    if AET.ae_exists(ae_dir):
        print(f"loading first stage from {ae_dir}")
        ae_model, ae_scale = AET.load_ae(ae_dir, device=device)
    else:
        steps = args.ae_steps or preset.ae_steps
        print(f"training first stage: {steps} steps -> {ae_dir}")
        acfg = preset.ae_config()
        torch.manual_seed(args.seed)  # the first stage's initial weights
        step_seconds = []
        ae_model, ae_scale, _ = AET.train_autoencoder(
            ConvAutoencoder(acfg), _ImageBatches(train_loader), steps, lr=args.ae_lr,
            log_every=max(steps // 10, 1), device=device, step_seconds=step_seconds)
        AET.save_ae(ae_dir, acfg, ae_model, ae_scale)
        print(f"first stage saved (scale_factor {ae_scale:.4f})")
        info.update(trained=True, steps=steps, step_seconds=step_seconds)
    info["scale_factor"] = ae_scale
    return AET.latent_process(inner, ae_model, ae_scale), info


def main(args):
    """Train for ``args.epochs`` epochs. Returns a summary dict: the steps
    taken, every step's loss and host-clock seconds (each ends in a fetch of
    the loss), the host-clock seconds each step waited for its batch from the
    feed before it, the seconds of the timed loop, the path of the last
    checkpoint and the final train state; for a latent preset also ``ae``,
    the first stage's (:func:`_latent_first_stage`)."""
    from eo_diffusion_torch.cli.presets import build_denoiser, build_process, get_preset
    from eo_diffusion_torch.data.factories import DATASET_FACTORIES
    from eo_diffusion_torch.data.loader import device_prefetch
    from eo_diffusion_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                                     save_checkpoint)
    from eo_diffusion_torch.train.trainer import Trainer, TrainerConfig
    from eo_diffusion_torch.utils.images import save_image_grid

    device = resolve_device(args.device, "eo_diffusion_torch.cli.train")
    preset = get_preset(args.preset)
    # flow, EDM, bridge and MeanFlow presets preview with their process's
    # own .sample; the DDPM chain has none, so fail before the first preview
    # hours in
    native = preset.process in ("flow", "edm", "bridge", "meanflow")
    if args.preview_sampler == "flow" and not native:
        raise SystemExit(f"--preview_sampler flow requires a flow-process preset (a flow, "
                         f"EDM, bridge or MeanFlow process); {preset.name} trains the DDPM "
                         f"chain (use ddpm/ddim)")
    preview_sampler = "flow" if native else args.preview_sampler
    dataset = args.dataset or preset.dataset
    factory = DATASET_FACTORIES[dataset]
    image_size = args.image_size or preset.image_size
    preset.image_size = image_size
    timesteps = args.timesteps or preset.timesteps
    if args.model_base_dim:
        preset.base_dim = args.model_base_dim
    cond_type = args.cond_type or preset.cond_type
    if cond_type not in (None, "sum", "concat"):
        raise NotImplementedError(f"--cond_type {cond_type} is not ported yet "
                                  "(ROADMAP queue 13)")
    if args.num_classes == 0 and preset.num_classes:
        args.num_classes = preset.num_classes
    if args.class_dropout == 0.0 and preset.class_dropout:
        # class-conditional presets train with CFG label dropout by default
        # (the null embedding row must exist for guidance)
        args.class_dropout = preset.class_dropout
    if preset.process == "meanflow" and preset.mf_cfg_omega != 1.0 and args.class_dropout == 0.0:
        # CFG-integrated MeanFlow: the null row must exist; the loss owns
        # the dropout itself (the trainer's is off for it)
        args.class_dropout = 0.1
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
    cond_channels = preset.cond_channels(batch0["cond"].shape[-1]) if has_cond else 0
    torch.manual_seed(args.seed)  # the model's initial weights
    model = build_denoiser(preset.model_config(
        bf16=not args.no_bf16, cond_channels=cond_channels, num_classes=num_classes,
        class_dropout_prob=args.class_dropout))
    diffusion = build_process(preset, timesteps, image_size, cond_type=cond_type)
    ae_info = None
    if preset.is_latent:
        diffusion, ae_info = _latent_first_stage(args, preset, diffusion, train_loader,
                                                 ckpt_dir, cond_type, device)

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

    # post-hoc EMA tracks: updated after every step, snapshotted at the
    # --save_every cadence and at the end; a resume restores the newest pair
    phema = tracks = None
    if args.posthoc_ema:
        from eo_diffusion_torch.train.posthoc_ema import PowerEMA

        phema = PowerEMA(tuple(float(g) for g in args.posthoc_gammas.split(",")))
        phema_dir = os.path.join(tcfg.ckpt_dir, "phema")
        tracks, snap_step = phema.restore_latest(
            phema_dir, dict(state.model.named_parameters()), cfg=model.config)
        if snap_step >= 0:
            print(f"posthoc-ema: tracks restored from snapshot step {snap_step}")

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
            if tracks is not None:
                phema.update(tracks, dict(state.model.named_parameters()), global_steps - 1)
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
                if tracks is not None:
                    phema.save_snapshots(phema_dir, tracks, global_steps - 1)
            t_wait = time.perf_counter()

    signal.signal(signal.SIGTERM, old_term)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t_start
    last_ckpt = save_checkpoint(tcfg.ckpt_dir, state.state_dict(), step=global_steps)
    if tracks is not None and global_steps > 0:
        phema.save_snapshots(phema_dir, tracks, global_steps - 1)
    result = {"steps": global_steps, "losses": losses, "seconds": dt,
              "step_seconds": step_seconds, "wait_seconds": wait_seconds,
              "checkpoint": last_ckpt, "state": state, "preempted": preempt["sig"]}
    if ae_info is not None:
        result["ae"] = ae_info
    if preempt["sig"] is not None:
        print(f"preempted (signal {preempt['sig']}): checkpoint saved at "
              f"step {global_steps}; rerun with --resume to continue")
        return result
    print(f"done: {global_steps} steps in {dt:.1f}s ({global_steps / max(dt, 1e-9):.2f} steps/s)")
    return result


if __name__ == "__main__":
    main(parse_args())
