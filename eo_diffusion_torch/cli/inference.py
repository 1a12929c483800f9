"""Sampling CLI of the port (the flags of ``eo_diffusion_tpu.cli.inference``
that the port has ported).

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
DDPM, DDIM, DPM-Solver++ (``--sampler dpm``, ``--dpm_spacing``) or UniPC
(``--sampler unipc``); flow-process presets (``dit256``, ``flow64``,
``cflow64``, ...), EDM presets (``edm64``, ...: Heun or Euler on the Karras
grid, ``--flow_method``), bridge presets (``bridge64``, ...: the strided
posterior walk from the cloudy view, ``--eta``, no CFG) and MeanFlow presets
(``meanflow64``, ``cmeanflow64``, ...: 1-4 average-velocity steps, Euler
only) with their native sampler, ``--sampler flow``, which they force.
Students of ``cli.distill`` sample with ``--sampler cm`` (consistency
distillation: ``--sampler_steps`` f evaluations on the ``--cd_points`` grid
with ``--sigma_data``) and ``--sampler pd`` (progressive distillation: a v
head on the ``--sampler_steps`` grid); ReFlow and guided flow students with
``--sampler flow``. Guidance:
classifier-free (``--guidance_scale`` against the learned null class of a
class-conditional preset, else against a zero cloudy view;
``--guidance_rescale``, ``--guidance_interval``), perturbed-attention
(``--pag_scale``) and autoguidance (``--autoguide_scale`` with a worse model
from ``--autoguide_ckpt`` or a short post-hoc EMA, ``--autoguide_sigma_rel``);
``--dynamic_threshold``, DeepCache (``--deepcache K``), SDEdit from the
cloudy view (``--sdedit_strength``) and post-hoc EMA weights
(``--phema_sigma_rel``, from ``cli.train --posthoc_ema``'s snapshots). The
JAX CLI's compatibility checks hold. ``--metrics`` scores each conditioned
batch's samples against the ground truth (SSIM and PSNR on the device, in
[0, 1]), prints the running means and writes them to ``<outdir>/metrics.txt``;
``--samples_fid`` writes every sample as its own PNG under
``<outdir>/samples_fid/`` for ``cli.evaluate``, named by class when the model
is class-conditional; ``--wandb`` is parsed and, as in the JAX CLI, does
nothing here. Classifier guidance (``--classifier_ckpt`` from
``cli.train_classifier``, ``--classifier_scale``) adds the noisy-image
classifier's input gradient to eps at every step of ddpm/ddim/dpm/unipc
(``diffusion/classifier_guidance.py``); its labels rotate through the
classifier's classes for an unconditional denoiser. A latent preset
(``latent256-cr``, ...) loads its first stage from ``--ae_ckpt`` (default ``ae`` beside ``--ckpt``),
samples on the latent grid with the cloudy view encoded, and decodes: the
metrics and PNGs are of the decoded pixels (``cm`` and ``pd`` run on the
latent grid, then decode). The other backbones: SPADE presets (``spade64``,
``tiny-spade``, ``--cond_type spade``: the test split's segmentation is the
segmap), the MoE DiT (``moe-dit64``, ``tiny-moe``), token merging on a DiT
preset (``--tome_ratio``, ``--tome_mlp``), FreeU on a UNet preset
(``--freeu B1,B2,S1,S2``) and a ControlNet adapter on a pixel-space UNet
preset (``--controlnet DIR``: the paired view is the hint that steers the
frozen base, which sees no concat cond), each with the JAX CLI's checks.
``--lora DIR`` merges a LoRA adapter of ``cli.finetune`` (``lora.npz`` +
``lora.json``, the JAX package's files) into the sampled weights once, at
load, with the ``alpha`` of its ``lora.json``. A super-resolution preset
(``sr64-256``, ``tiny-sr``) conditions on the degraded view of the test
batch's own ground truth (``data.transforms.sr_cond``), so ``--metrics``
scores a super-resolution. ``--int8_compute`` runs the whole sampling run
inside ``nn.primitives.int8_dense_compute()`` (W8A8: the large ``Dense``
products as int8 x int8 -> int32 with per-channel weight and per-tensor
activation scales; a DiT-preset lever), as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import time

import numpy as np
import torch

from eo_diffusion_torch.cli.common import resolve_device

# flags of the JAX sampling CLI that are not ported yet -> ROADMAP queue; a
# name ending in "_" stands for every flag that starts with it (none is left)
UNPORTED_FLAGS = {}


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
                        choices=["ddpm", "ddim", "dpm", "unipc", "flow", "cm", "pd"],
                        help="dpm = DPM-Solver++(2M); unipc = UniPC-3 (num_steps + 1 model "
                             "calls); flow = the native sampler of flow, EDM, bridge and "
                             "MeanFlow presets, which force it; cm = consistency-model "
                             "sampling (students of cli.distill --method consistency); pd = "
                             "the progressive-distillation grid (students of cli.distill "
                             "--method progressive; --sampler_steps = the student's steps)")
    parser.add_argument("--cd_points", type=int, default=18,
                        help="cm sampler: consistency grid points (must match distillation)")
    parser.add_argument("--sigma_data", type=float, default=0.5,
                        help="cm sampler: data std of the boundary coefficients (must match "
                             "distillation)")
    parser.add_argument("--dpm_spacing", type=str, default="uniform_lambda",
                        choices=["uniform_lambda", "uniform_t", "karras"],
                        help="DPM-Solver grid: uniform half-log-SNR, DDIM-style t stride, or "
                             "the Karras rho-7 curve")
    parser.add_argument("--dynamic_threshold", type=float, default=None, metavar="P",
                        help="Imagen dynamic thresholding percentile (e.g. 0.995) in place "
                             "of the static x0 clamp; ddpm/ddim/dpm/unipc")
    parser.add_argument("--guidance_scale", type=float, default=1.0,
                        help="classifier-free guidance scale (>1 enables): against the "
                             "learned null class of a class-conditional model, else against "
                             "a zero conditioning image")
    parser.add_argument("--guidance_rescale", type=float, default=0.0,
                        help="CFG-rescale phi (arXiv:2305.08891 §3.4; ~0.7)")
    parser.add_argument("--guidance_interval", type=str, default=None, metavar="LO,HI",
                        help="apply CFG only while the normalized noise level is in "
                             "[LO, HI] (arXiv:2404.07724), e.g. 0.2,0.8")
    parser.add_argument("--pag_scale", type=float, default=0.0,
                        help="perturbed-attention guidance weight (arXiv:2403.17377; >0 "
                             "enables)")
    parser.add_argument("--autoguide_scale", type=float, default=1.0,
                        help="autoguidance weight (arXiv:2406.02507; >1 enables)")
    parser.add_argument("--autoguide_ckpt", type=str, default=None,
                        help="the worse model's checkpoint (e.g. an early steps_* file)")
    parser.add_argument("--autoguide_sigma_rel", type=float, default=0.0,
                        help="the worse model as a short post-hoc EMA of this sigma_rel")
    parser.add_argument("--phema_sigma_rel", type=float, default=0.0,
                        help="sample with the post-hoc EMA of this sigma_rel, synthesized "
                             "from cli.train --posthoc_ema's snapshots")
    parser.add_argument("--phema_dir", type=str, default=None,
                        help="snapshot directory (default: phema beside --ckpt)")
    parser.add_argument("--deepcache", type=int, default=1, metavar="K",
                        help="DeepCache (arXiv:2312.00858): run the deep UNet branch only "
                             "every K steps (K>1 enables; UNet presets)")
    parser.add_argument("--sdedit_strength", type=float, default=0.0,
                        help="SDEdit (arXiv:2108.01073): noise the source (the cloudy "
                             "view, else the image) this fraction of the chain and denoise "
                             "back (0 = off)")
    parser.add_argument("--num_classes", type=int, default=0,
                        help="class-conditional models (default: the preset's)")
    parser.add_argument("--class_dropout", type=float, default=0.0,
                        help="must match training: builds the null-class row label-CFG "
                             "needs (default: the preset's)")
    parser.add_argument("--random_label", action="store_true",
                        help="cond_type sum: a random rectangle as the mask")
    parser.add_argument("--cond_type", type=str, default=None,
                        help="override the preset's conditioning (sum | concat)")
    parser.add_argument("--model_base_dim", type=int, default=None)
    parser.add_argument("--flow_method", type=str, default="euler", choices=["euler", "heun"],
                        help="flow and EDM integrator (heun: 2nd order, 2 model calls a step)")
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
    parser.add_argument("--classifier_ckpt", type=str, default=None,
                        help="classifier guidance (Dhariwal & Nichol 2021): directory written "
                             "by cli.train_classifier (classifier + classifier.json)")
    parser.add_argument("--classifier_scale", type=float, default=0.0,
                        help="classifier-guidance gradient scale (>0 enables; needs "
                             "--classifier_ckpt)")
    parser.add_argument("--ae_ckpt", type=str, default=None,
                        help="latent presets: trained first-stage directory "
                             "(default: 'ae' beside --ckpt)")
    parser.add_argument("--tome_ratio", type=float, default=0.0,
                        help="token merging (ToMe, arXiv:2303.17604) on DiT presets: the share "
                             "of tokens merged inside every block's attention; parameter-free, "
                             "so any checkpoint loads under it (~0.3-0.5 is the useful range)")
    parser.add_argument("--tome_mlp", action="store_true",
                        help="extend --tome_ratio's merge around the MLP branch")
    parser.add_argument("--freeu", type=str, default=None, metavar="B1,B2,S1,S2",
                        help="FreeU (arXiv:2309.11497) on UNet presets: amplify the backbone "
                             "features (b > 1) and damp the skips' low frequencies (s < 1) at "
                             "the two deepest decoder stages, e.g. 1.2,1.3,0.9,0.4")
    parser.add_argument("--controlnet", type=str, default=None,
                        help="ControlNet adapter directory (controlnet.npz, the JAX "
                             "package's layout): the dataset's paired view steers the frozen "
                             "base checkpoint through the zero-init control branch "
                             "(arXiv:2302.05543; pixel-space UNet presets)")
    parser.add_argument("--int8_compute", action="store_true",
                        help="W8A8: large Dense products as int8 x int8 -> int32 with "
                             "per-channel weight and dynamic per-tensor activation scales "
                             "(nn.primitives.int8_dense_compute); a DiT-preset lever")
    parser.add_argument("--lora", type=str, default=None,
                        help="LoRA adapter directory (lora.npz + lora.json from cli.finetune, "
                             "the JAX package's layout) merged into the sampled weights")
    for arg in (argv if argv is not None else __import__("sys").argv[1:]):
        hit = _unported_flag(arg)
        if hit:
            parser.error(f"{hit[0]} is not ported yet (ROADMAP queue {hit[1]})")
    return parser.parse_args(argv)


def _build_cond(batch, cond_type, image_size=None, random_label=False, mask_rng=None,
                sr_factor=0):
    """(cond, mask) for one batch (reference inference.py:98-109): the segmap
    for ``cond_type="spade"``; for an ``sr_factor`` preset the degraded view
    of the batch's own image (``data.transforms.sr_cond``); a paired
    "cond_image" view is the concat conditioning; otherwise (image | mask)
    with the mask inverted for ``cond_type="sum"`` (known = non-cloud), or a
    random rectangle a sample with ``random_label``."""
    if cond_type is None:
        return None, None
    image = np.asarray(batch["image"], np.float32)
    if cond_type == "spade":
        # the segmap itself is the conditioning (the SPADE norms read it)
        if "segmentation" not in batch:
            return None, None
        return np.asarray(batch["segmentation"], np.float32), None
    if cond_type == "concat" and sr_factor:
        from eo_diffusion_torch.data.transforms import sr_cond

        return sr_cond(image, sr_factor), None
    if cond_type == "concat" and "cond_image" in batch:
        return np.asarray(batch["cond_image"], np.float32), None
    mask = (np.asarray(batch["segmentation"], np.float32)
            if "segmentation" in batch else None)
    if cond_type == "sum" and mask is not None:
        mask = 1.0 - mask
    if random_label and cond_type == "sum":
        from eo_diffusion_torch.data.transforms import random_rect_mask

        mask = np.stack([random_rect_mask((image_size, image_size), 10, 10, 40, 40, mask_rng)
                         for _ in range(image.shape[0])])
    if mask is None:
        return None, None
    return np.concatenate([image, mask], axis=-1), mask


def _load_params(model, tree) -> None:
    """Copy a parameter state dict (name -> tensor) into ``model``."""
    with torch.no_grad():
        for name, prm in model.named_parameters():
            prm.copy_(tree[name])


def main(args):
    """Sample ``args.n_iter + 1`` batches. Returns a summary dict with the
    last batch's samples (``[N, H, W, C]`` float32 numpy), the batch and
    image counts and the seconds spent inside the samplers, in all and by
    batch; with ``--metrics`` also the mean ``ssim`` and ``psnr``. Under
    ``--int8_compute`` every model call of the run takes the W8A8 ``Dense``
    route."""
    from eo_diffusion_torch.nn.primitives import int8_dense_compute

    w8a8 = (int8_dense_compute() if getattr(args, "int8_compute", False)
            else contextlib.nullcontext())
    with w8a8:
        return _run(args)


def _run(args):
    from eo_diffusion_torch.cli.presets import build_denoiser, build_process, get_preset
    from eo_diffusion_torch.diffusion.gaussian import noise_level
    from eo_diffusion_torch.data.datasets import class_names
    from eo_diffusion_torch.data.factories import DATASET_FACTORIES
    from eo_diffusion_torch.utils import metrics as M
    from eo_diffusion_torch.utils.images import rescale_to_unit, save_image_grid
    from eo_diffusion_torch.weights import load_reference_checkpoint

    device = resolve_device(args.device, "eo_diffusion_torch.cli.inference")
    preset = get_preset(args.preset)
    dataset = args.dataset or preset.dataset
    factory = DATASET_FACTORIES[dataset]
    image_size = args.image_size or preset.image_size
    preset.image_size = image_size
    timesteps = args.timesteps or preset.timesteps
    if args.model_base_dim:
        preset.base_dim = args.model_base_dim
    cond_type = args.cond_type or preset.cond_type
    if args.controlnet:
        # the hint rides the concat cond's data path (the paired view, the
        # samplers' cond, the metrics against the ground truth) while the base
        # stays unconditional: cond_channels is zeroed below and model_fn
        # routes the cond into the control branch
        assert preset.backbone == "unet" and not preset.is_latent, (
            "--controlnet adapters are wired for pixel-space UNet presets")
        assert cond_type in (None, "concat"), (
            f"--controlnet replaces '{cond_type}' conditioning; use an unconditional or "
            "concat-data preset")
        assert args.deepcache <= 1, (
            "DeepCache wraps the model directly and would bypass the control residuals; drop "
            "one of the two")
        assert args.autoguide_scale == 1.0, (
            "autoguidance's degraded branch runs without the control residuals (and would "
            "mis-concat the hint); drop one of the two")
        cond_type = "concat"
    # class-conditional presets sample conditional, with their null row,
    # unless the flags say otherwise (the training CLI's defaults)
    num_classes = args.num_classes or preset.num_classes or None
    assert not (args.classifier_scale and not args.classifier_ckpt), (
        "--classifier_scale needs --classifier_ckpt (train one with cli.train_classifier)")
    class_dropout = args.class_dropout or preset.class_dropout
    if preset.process == "meanflow" and preset.mf_cfg_omega != 1.0 and not class_dropout:
        class_dropout = 0.1  # cli.train's default there: the null row exists
    # an explicit cm / pd request on a preset of another process is an
    # error, not a coercion target
    for sampler, method in (("cm", "consistency"), ("pd", "progressive")):
        assert not (args.sampler == sampler and preset.process != "ddpm"), (
            f"--sampler {sampler} samples a {method}-distilled DDPM-chain student "
            f"(cli.distill --method {method}); {preset.name} trains {preset.process}")
    # "flow" means the process's native sampler: the flow ODE, EDM's Heun on
    # the Karras grid, the bridge's posterior walk or MeanFlow's segments
    # (one .sample surface)
    if preset.process in ("flow", "edm", "bridge", "meanflow") and args.sampler != "flow":
        print(f"preset {preset.name} is a {preset.process} process; using --sampler flow "
              "(its native sampler)")
        args.sampler = "flow"
    if preset.process == "meanflow" and args.flow_method != "euler":
        print("note: MeanFlow applies its own average-velocity displacement; ignoring "
              f"--flow_method {args.flow_method}")
        args.flow_method = "euler"
    if preset.process == "bridge" and args.guidance_scale != 1.0:
        print("note: the bridge is endpoint-conditional; no CFG combine — ignoring "
              "--guidance_scale")
        args.guidance_scale = 1.0
    if args.sampler == "flow" and preset.process == "ddpm":
        raise SystemExit(f"--sampler flow requires a flow-process preset (a flow, EDM or "
                         f"bridge process); {preset.name} trained the {preset.process} chain "
                         f"(use ddpm/ddim/dpm/unipc)")
    # the JAX CLI's compatibility checks (eo_diffusion_tpu/cli/inference.py:330-700)
    if args.sdedit_strength:
        assert preset.process in ("ddpm", "flow", "meanflow"), (
            f"SDEdit is wired for DDPM-chain and flow/meanflow presets; {preset.name} trains "
            f"{preset.process}")
        assert cond_type != "sum", (
            "SDEdit starts FROM the source image; RePaint 'sum' masking is a different "
            "mechanism (drop --sdedit_strength or use cond_type concat/None)")
        if args.sampler in ("ddpm", "dpm", "unipc"):
            print("note: SDEdit runs the DDIM tail; using --sampler ddim")
            args.sampler = "ddim"
    assert args.dynamic_threshold is None or args.sampler in ("ddpm", "ddim", "dpm", "unipc"), (
        f"--dynamic_threshold rescales the DDPM-family pred-x0 clamp (ddpm/ddim/dpm/unipc); "
        f"the {args.sampler} sampler has no such site")
    assert args.sdedit_strength == 0.0 or args.sampler in ("ddim", "flow"), (
        f"--sdedit_strength does not compose with --sampler {args.sampler}")
    assert not (args.sampler in ("cm", "pd") and args.deepcache > 1), (
        f"{args.sampler} is already 1-4 evaluations; DeepCache does not apply")
    assert not (args.sampler in ("cm", "pd") and args.controlnet), (
        f"the {args.sampler} sampler runs the distilled student directly; --controlnet wraps "
        "the plain denoiser (use ddpm/ddim/dpm/unipc)")
    assert not (args.sampler in ("cm", "pd") and cond_type == "sum"), (
        f"{args.sampler} has no RePaint mask plumbing; cond_type='sum' metrics would compare "
        "unconditional samples against gt (use ddim/dpm)")
    if args.sampler in ("cm", "pd") and args.guidance_scale != 1.0:
        print(f"note: the {args.sampler} sampler has no guidance combine; ignoring "
              "--guidance_scale")
        args.guidance_scale = 1.0
    assert args.deepcache <= 1 or preset.backbone == "unet", (
        "DeepCache caches the UNet's deep/shallow split; the DiT backbone has no "
        "resolution ladder to split")
    if args.autoguide_scale > 1.0:
        assert args.guidance_scale == 1.0, (
            "autoguidance and classifier-free guidance both own the guided combine; pick "
            "one (--autoguide_scale xor --guidance_scale)")
        assert args.deepcache <= 1, (
            "DeepCache's stateful fn wraps the model directly and would bypass the "
            "autoguided combine; drop one of the two")
        assert args.autoguide_ckpt or args.autoguide_sigma_rel, (
            "--autoguide_scale needs a degraded model: pass --autoguide_ckpt or "
            "--autoguide_sigma_rel")
    if args.pag_scale > 0.0:
        assert args.deepcache <= 1, (
            "DeepCache's stateful fn wraps the model directly and would bypass the PAG "
            "combine; drop one of the two")
    if args.classifier_ckpt:
        assert not preset.is_latent, (
            "classifier guidance reads pixels; latent presets are not wired")
        assert args.sampler in ("ddpm", "ddim", "dpm", "unipc"), (
            "classifier guidance steers the DDPM chain via an eps-space gradient; "
            f"--sampler {args.sampler} does not apply")
        assert args.deepcache <= 1, (
            "classifier guidance wraps the plain denoiser fn; it is not composed with "
            "DeepCache's stateful fn")
        assert args.guidance_scale == 1.0, (
            "classifier guidance and classifier-FREE guidance are separate steering "
            "mechanisms (CFG doubles the batch under the wrapper, breaking the classifier's "
            "per-sample labels); pick one")
    if preset.is_latent:
        assert cond_type != "sum", (
            "latent presets do not support RePaint-'sum' conditioning (pixel-space mask "
            "composite); use cond_type='concat'")

    fkw = dict(batch_size=args.batch_size, test=True)
    if args.data_root:
        fkw["root"] = args.data_root
    if dataset == "synthetic":
        fkw["image_size"] = image_size
        fkw["channels"] = preset.in_channels
        if cond_type == "concat" and not preset.sr_factor:
            # the synthetic cloudy view as cond (an SR preset derives its cond
            # from the ground truth)
            fkw["with_cond_image"] = True
        fkw.pop("test")
    _, test_loader = factory(**fkw)
    data_range = test_loader.dataset.data_range
    peek = {k: np.asarray(v)[None] for k, v in test_loader.dataset[0].items()}
    peek_cond, _ = _build_cond(peek, cond_type, sr_factor=preset.sr_factor)
    # "spade" differs from "concat" only in how the cond is built (the segmap)
    # and which backbone reads it; downstream it is a concat cond
    build_cond_type = cond_type
    if cond_type == "spade":
        cond_type = "concat"
    has_cond = cond_type == "concat" and peek_cond is not None
    cond_channels = preset.cond_channels(peek_cond.shape[-1]) if has_cond else 0
    hint_channels = 0
    if args.controlnet:
        assert has_cond, ("--controlnet needs a paired hint view from the dataset "
                          "(cond_image / image|mask)")
        hint_channels, cond_channels = cond_channels, 0

    ucfg = preset.model_config(bf16=not args.no_bf16, cond_channels=cond_channels,
                               num_classes=num_classes, class_dropout_prob=class_dropout)
    if args.tome_ratio:
        assert preset.backbone == "dit", (
            "--tome_ratio merges transformer tokens (DiT presets); the UNet has no token axis "
            "(use --deepcache there)")
        # parameter-free: any checkpoint loads under the merged config
        ucfg = dataclasses.replace(ucfg, tome_ratio=args.tome_ratio, tome_mlp=args.tome_mlp)
    if args.freeu:
        assert preset.backbone == "unet", (
            "--freeu re-weights the UNet decoder's skip joins; the DiT has no decoder ladder "
            "(use --tome_ratio there)")
        vals = tuple(float(v) for v in args.freeu.split(","))
        assert len(vals) == 4, "--freeu needs B1,B2,S1,S2"
        ucfg = dataclasses.replace(ucfg, freeu=vals)  # parameter-free, like ToMe
    model = build_denoiser(ucfg)
    if args.ckpt:
        print("loading checkpoint...")
        model.load_state_dict(load_reference_checkpoint(args.ckpt, ucfg), strict=True)
        print("loaded!")
    model = model.to(device).eval()
    phema_dir = args.phema_dir or os.path.join(os.path.dirname(os.path.abspath(args.ckpt)),
                                               "phema")
    if args.phema_sigma_rel:
        # post-hoc EMA: the EMA of the requested length, synthesized from the
        # power-EMA snapshots, in place of the checkpoint's EMA for this run
        from eo_diffusion_torch.train.posthoc_ema import synthesize_from_dir

        _load_params(model, synthesize_from_dir(phema_dir, dict(model.named_parameters()),
                                                args.phema_sigma_rel, cfg=ucfg))
        print(f"posthoc-ema: synthesized sigma_rel={args.phema_sigma_rel} from {phema_dir}")
    if args.lora:
        # the adapter merges into the sampled weights once (JAX merges it into
        # the EMA tree it samples)
        from eo_diffusion_torch.cli.finetune import load_lora
        from eo_diffusion_torch.train.lora import lora_merge_

        lora, lmeta = load_lora(args.lora)
        lora_merge_(model, lora, alpha=lmeta.get("alpha", 8.0))
        print(f"LoRA adapter merged: {len(lora)} kernels from {args.lora}")
    diffusion = build_process(preset, timesteps, image_size, cond_type=cond_type)
    if preset.is_latent:
        from eo_diffusion_torch.train import ae_trainer as AET

        ae_dir = args.ae_ckpt or os.path.join(os.path.dirname(args.ckpt), "ae")
        if not AET.ae_exists(ae_dir):
            raise FileNotFoundError(
                f"latent preset {preset.name} needs a trained first stage; none at "
                f"{ae_dir} (train one with cli.train, or pass --ae_ckpt)")
        diffusion = AET.latent_process(diffusion, *AET.load_ae(ae_dir, device=device))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Diffusion with {n_params / 1e6} M params on {device}")
    model_fn = lambda x, t, c, y: model(x, t, cond=c, y=y)
    if args.controlnet:
        from eo_diffusion_torch.models.controlnet import ControlNet, load_controlnet

        cnet = ControlNet(ucfg, hint_channels)
        load_controlnet(args.controlnet, cnet)
        cnet = cnet.to(device).eval()
        print(f"ControlNet adapter loaded from {args.controlnet} "
              f"(hint_channels={hint_channels})")
        model_fn = lambda x, t, c, y: model(x, t, y=y, control=cnet(x, t, c, y=y))

    if args.autoguide_scale > 1.0:
        # autoguidance: extrapolate away from a worse variant of the same model,
        # an earlier checkpoint or a short post-hoc EMA
        from eo_diffusion_torch.diffusion.autoguide import autoguided_model_fn

        bad = build_denoiser(ucfg)
        if args.autoguide_ckpt:
            bad.load_state_dict(load_reference_checkpoint(args.autoguide_ckpt, ucfg),
                                strict=True)
            bad = bad.to(device).eval()
        else:
            from eo_diffusion_torch.train.posthoc_ema import synthesize_from_dir

            bad = bad.to(device).eval()
            _load_params(bad, synthesize_from_dir(phema_dir, dict(model.named_parameters()),
                                                  args.autoguide_sigma_rel, cfg=ucfg))
            print(f"autoguide: bad model = sigma_rel={args.autoguide_sigma_rel} from "
                  f"{phema_dir}")
        # the interval gate sees the model's t; invert it to the process's
        # normalized noise level: on the flow ODE t * time_scale, under EDM
        # ln(sigma) / 4 * time_scale -> sigma / sigma_max (edm.py's own gate),
        # in float32
        inner = diffusion.diffusion if preset.is_latent else diffusion
        nf = None
        if preset.process in ("flow", "meanflow"):
            # MeanFlow packs t as [N, 2] = (t, r); row 0's first entry is the time
            nf = lambda t: noise_level(t.reshape(t.shape[0], -1)[0, 0], inner.time_scale)
        elif preset.process == "edm":
            nf = lambda t: noise_level(torch.exp(4.0 * t[0].float() / inner.time_scale),
                                       inner.sigma_max)
        model_fn = autoguided_model_fn(
            model_fn, lambda x, t, c, y: bad(x, t, cond=c, y=y), args.autoguide_scale,
            guidance_rescale=args.guidance_rescale,
            guidance_interval=_interval(args.guidance_interval), timesteps=timesteps,
            noise_frac_fn=nf)
    if args.pag_scale > 0.0:
        from eo_diffusion_torch.diffusion.pag import pag_model_fn

        model_fn = pag_model_fn(model_fn, args.pag_scale)
        print(f"PAG enabled: scale={args.pag_scale}")
    classifier, clf_classes = None, 0
    if args.classifier_ckpt:
        from eo_diffusion_torch.cli.train_classifier import load_classifier
        from eo_diffusion_torch.diffusion.classifier_guidance import classifier_guided

        classifier, cmeta = load_classifier(args.classifier_ckpt, device)
        assert classifier.config.image_size == image_size, (
            f"classifier was trained at {classifier.config.image_size}px (preset "
            f"{cmeta['preset']}); sampling at {image_size}px")
        clf_classes = int(cmeta["num_classes"])
        print(f"classifier guidance: scale={args.classifier_scale}, {clf_classes} classes "
              f"from {args.classifier_ckpt}")

    classes = class_names(dataset, num_classes or 0)
    dir_samples = os.path.join(args.outdir, "samples")
    dir_fid = os.path.join(args.outdir, "samples_fid")
    os.makedirs(dir_samples, exist_ok=True)
    os.makedirs(dir_fid, exist_ok=True)
    offset = len(os.listdir(dir_samples)) // (1 if cond_type is None else 3)

    print("start inference")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    mask_rng = np.random.default_rng(args.seed)
    to_dev = lambda a: None if a is None else torch.as_tensor(a, device=device)
    samples, n_images, batch_seconds, n = None, 0, [], 0
    ssim_sum, psnr_sum = 0.0, 0.0
    with torch.inference_mode():
        for j, batch in enumerate(test_loader):
            print(f"data {j}")
            image = np.asarray(batch["image"], np.float32)
            bsz = image.shape[0]
            cond, mask = _build_cond(batch, build_cond_type, image_size, args.random_label,
                                     mask_rng, sr_factor=preset.sr_factor)
            # class rotation like the reference's inference.py:110
            y = (np.full((bsz,), min(j % max(num_classes - 1, 1), num_classes - 1))
                 if num_classes else None)
            catg = classes[int(y[0])] if y is not None else "sample"
            gkw = _guidance_kwargs(args, ucfg, num_classes, cond_type, cond, bsz)
            fn_j, st0 = model_fn, None
            if args.deepcache > 1:
                from eo_diffusion_torch.diffusion.deepcache import deepcache_model_fn

                # under CFG the doubled batch flows through the stateful fn,
                # so the cached feature is the doubled batch's
                fn_j, st0 = deepcache_model_fn(model, refresh_every=args.deepcache)
            if classifier is not None and args.classifier_scale:
                # an unconditional denoiser still gets per-batch targets: the
                # classifier's classes in rotation, like the y rotation
                clf_y = y if y is not None else np.full((bsz,), j % clf_classes)
                fn_j = classifier_guided(diffusion, fn_j, classifier,
                                         torch.as_tensor(clf_y, dtype=torch.long, device=device),
                                         scale=args.classifier_scale)
                if y is None:
                    catg = class_names(dataset, clf_classes)[int(clf_y[0])]
            c_j = to_dev(cond) if cond_type == "concat" else None
            y_j = None if y is None else torch.as_tensor(y, dtype=torch.long, device=device)
            gkw = {k: (to_dev(v) if isinstance(v, np.ndarray) else v) for k, v in gkw.items()}
            mask_j = to_dev(mask) if cond_type == "sum" else None
            x0_j = to_dev(image) if mask_j is not None else None
            skw = dict(device=device, generator=generator, y=y_j, model_state=st0, **gkw)
            t0 = time.perf_counter()
            if args.sdedit_strength:
                from eo_diffusion_torch.diffusion.edit import sdedit_sample

                # the source is the paired view (the cloudy scene), else the image
                source = batch["cond_image"] if "cond_image" in batch else image
                out = sdedit_sample(
                    diffusion, fn_j, torch.as_tensor(np.asarray(source, np.float32)),
                    args.sdedit_strength, num_steps=args.sampler_steps, eta=args.eta,
                    method=args.flow_method if args.sampler == "flow" else args.ddim_spacing,
                    cond=c_j, **skw)
            elif args.sampler in ("cm", "pd"):
                out = _distilled_sample(args, diffusion, preset.is_latent, fn_j, bsz, c_j,
                                        skw)
            elif args.sampler == "flow" and preset.process == "bridge":
                # paired translation: the source view is the bridge's endpoint;
                # --eta scales the posterior noise as DDIM's does
                assert c_j is not None, (
                    "bridge sampling needs the source image (a dataset with cond_image and "
                    "cond_type='concat')")
                out = diffusion.sample(fn_j, bsz, num_steps=args.sampler_steps, cond=c_j,
                                       clip=not args.no_clip, eta=args.eta, **skw)
            elif args.sampler == "flow":
                out = diffusion.sample(fn_j, bsz, num_steps=args.sampler_steps,
                                       method=args.flow_method, cond=c_j, mask=mask_j,
                                       x0=x0_j, **skw)
            elif args.sampler == "ddpm":
                out = diffusion.ddpm_sample(
                    fn_j, bsz, cond=to_dev(cond), clip=not args.no_clip,
                    dynamic_threshold=args.dynamic_threshold,
                    jump_len=args.jump_len, jump_n=args.jump_n, **skw)
            elif args.sampler in ("dpm", "unipc"):
                extra = dict(time_spacing=args.dpm_spacing) if args.sampler == "dpm" else {}
                sampler = getattr(diffusion, f"{args.sampler}_sample")
                out = sampler(fn_j, bsz, num_steps=args.sampler_steps, cond=c_j, mask=mask_j,
                              x0=x0_j, dynamic_threshold=args.dynamic_threshold, **extra,
                              **skw)
            else:
                out = diffusion.ddim_sample(
                    fn_j, bsz, num_steps=args.sampler_steps, eta=args.eta,
                    method=args.ddim_spacing, cond=c_j, mask=mask_j, x0=x0_j,
                    clip=args.ddim_clip, dynamic_threshold=args.dynamic_threshold, **skw)
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
            if args.samples_fid:
                for i in range(bsz):
                    save_image_grid(samples01[i], os.path.join(dir_fid, f"{catg}_{idx}-{i}.png"))
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


def _distilled_sample(args, diffusion, is_latent, fn, bsz, cond, skw):
    """``--sampler cm`` or ``pd``: the student of ``cli.distill`` on the
    inner chain (the latent grid of a latent preset: the concat cond encoded
    by the first stage, the result decoded), as the JAX CLI runs it."""
    import dataclasses

    from eo_diffusion_torch.diffusion.consistency import ConsistencyDistillation
    from eo_diffusion_torch.diffusion.gaussian import DiffusionOutput
    from eo_diffusion_torch.diffusion.progressive import pd_sample

    inner = diffusion.diffusion if is_latent else diffusion
    if is_latent and cond is not None:
        cond = diffusion.encode(cond)
    kw = dict(device=skw["device"], generator=skw["generator"], cond=cond, y=skw["y"])
    if args.sampler == "cm":
        cd = ConsistencyDistillation.create(inner, n_points=args.cd_points,
                                            sigma_data=args.sigma_data)
        z = cd.sample(fn, bsz, steps=args.sampler_steps, **kw).x
    else:  # progressive students are v heads on the PD grid
        z = pd_sample(dataclasses.replace(inner, objective="v"), fn, bsz,
                      steps=args.sampler_steps, **kw).x
    return DiffusionOutput(x=diffusion.decode(z) if is_latent else z)


def _interval(text):
    """``"LO,HI"`` -> ``(lo, hi)`` with 0 <= LO < HI <= 1, or None."""
    if not text:
        return None
    lo, hi = (float(v) for v in text.split(","))
    assert 0.0 <= lo < hi <= 1.0, (
        f"--guidance_interval {text}: need 0 <= LO < HI <= 1 (normalized noise level)")
    return lo, hi


def _guidance_kwargs(args, ucfg, num_classes, cond_type, cond, bsz) -> dict:
    """The samplers' classifier-free guidance keywords for one batch (the JAX
    CLI's ``gkw``): label-CFG against the learned null class when the model
    is class-conditional and has that row, else image-CFG against a zero
    conditioning view; empty when guidance is off or cannot apply."""
    if args.guidance_scale == 1.0:
        return {}
    gkw = {"guidance_scale": args.guidance_scale}
    if args.guidance_rescale:
        gkw["guidance_rescale"] = args.guidance_rescale
    if args.guidance_interval:
        gkw["guidance_interval"] = _interval(args.guidance_interval)
    if num_classes:
        if (ucfg.label_vocab or 0) <= num_classes:
            print("note: label-CFG needs a null-class row (train with --class_dropout > 0); "
                  "guidance ignored")
            return {}
        gkw["y_uncond"] = np.full((bsz,), num_classes, np.int64)
    elif cond_type == "concat" and cond is not None:
        if args.sampler == "ddpm":
            print("note: ddpm has no image-CFG path; guidance ignored")
            return {}
        gkw["uncond"] = np.zeros_like(cond)
    else:
        print("note: --guidance_scale needs class- or concat-conditioning; ignored")
        return {}
    return gkw


if __name__ == "__main__":
    main(parse_args())
