"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --only wide   # phases 1, 2, phase 3's wide rows, 5i
    python3 chip_smoke.py --only f32    # phases 1, 2, 5j (its kernel rows and runs)
    python3 chip_smoke.py --only few    # phases 1, 2, 5k (its kernel rows and runs)

Phases, in order; the first failure exits non-zero:

1. require CUDA; print the card's name and power limit; TF32 off;
2. build every CUDA kernel of the port from the sources in this checkout,
   and count the wgmma (HGMMA) and TMA (UTMALDG) instructions of the bf16
   attention forward and backward, the mma.sync HMMA of the wide kernels
   and the TF32 mma.sync (HMMA.1688.F32.TF32) of the float32 kernel, and
   print ptxas's registers and spills for each of its entry functions;
3. hold each kernel (attention forward through its fused-qkv entry and
   through its separate-tensor entry, attention backward through both,
   GroupNorm + FiLM + SiLU forward and backward) against its plain PyTorch
   version on the card at the shapes the main paths give it (the clouds UNet
   at 256, 384 and 512 px), and time kernel, plain version, the PyTorch
   library call and the card's lower bound. The bf16 forward is the
   wgmma/TMA body: at every shape it is also held at unit-normal inputs to
   the probes' limits (TOL of max(rms, |plain|), TOL_ATTN_L2), two planted
   faults are asserted caught, and the mma.sync body it replaced is timed
   beside it; head dims 160 and 256 and a ragged T for each entry too. The
   bf16 backward is the wgmma/TMA body too, held the same way at every
   backward shape (TOL_BWD of max(rms, |plain|), TOL_BWD_L2; the faults: its
   gradients 1 % off, one streamed query tile of the KV pass dropped), with
   the mma.sync backward timed beside it, head dims 160 and 256 included.
   The wide kernels (attention_wide.cu: head dims above 256 in bf16 and 128
   in float32, at any T, keys streamed, bf16 on the tensor cores; phase 2
   counts its HMMA) are held the same way through the same entries at
   inria64's middle attention (one head of D 1024, bf16: B8 forwards at T
   64, 1024 and 4096, B16 and B4 backwards at T 64 and 4096) and at a ragged
   float32 shape (T 130, D 136), with the first wide pair
   (attention_wide_resident.cu, T up to 1024) timed beside them.
   GroupNorm runs the one-launch body (group_norm_sm90.cu) at the clouds
   UNet's level shapes: its statistics are held against float64
   (TOL_GN_STATS), a chunk of rows lost from the combine is planted at three
   shapes and asserted caught by that check, a repeat must give the same
   bits, and the old three-launch body (group_norm.cu) is timed beside it;
4. one clouds-UNet forward at 256 px, kernels against the all-plain model
   (plain attention and plain norms), then one loss and backward, kernels
   against plain: every parameter gets a finite gradient, the attention's
   qkv weights a non-zero one; 4b. the same at 384 px, batch 1, where every
   attention takes the separate-tensor route; 4d. a ``dit256`` (DiT-B/8)
   flow-matching loss and backward at 256 px, batch 16, kernels against the
   all-plain model, the same limits: K1 with the lse and K4 once a block in
   the new head order, every gradient finite; 4e. ``latent256-cr`` at batch
   32: its float32 f4 first stage (base 128, seeded) encode -> decode and one
   reconstruction loss and backward against the all-plain AE (TOL_AE_REL;
   6 GroupNorm launches a direction, no weight-gradient kernel), then one
   DiT-B/4 flow loss and backward on the encoded x0 and cloudy view against
   the all-plain DiT and AE (phase 4d's limits): K1 with the lse and K4 once
   a block, the first stage forward only (6 GroupNorm launches, none
   backward, no gradient on its weights);
5. the sampling path through the entry point: ``eo_diffusion_torch.cli.inference``
   with ``sen12mscr256`` (concat cloud removal), DDIM-50, batch 8, seeded
   random weights; the attention counter (the wgmma/TMA body) must rise by
   11 x 50 per batch, the mma.sync bodies' (forward and backward) not at all
   (in every run of phases 4-7), and the GroupNorm counter by 56 x 50; 5b. the same entry
   point at ``--image_size 512``, DDIM-20 (5 separate-tensor and 6
   fused-qkv launches a forward); 5c. ``tiled_ddim_sample`` of 512 x 512
   scenes with the 256 px denoiser (3 x 3 tiles at overlap 0.5, DDIM-20);
6. the reference's own 64 px path: ``clouds64-attn`` RePaint DDPM-100;
5d. the DiT family through the same entry point: ``dit256`` (DiT-B/8, 12
   blocks, hidden 768, 12 heads, patch 8) with rectified flow, Heun-8 (15
   model calls, 180 fused-qkv attention launches a batch) and Euler-32 (384),
   and ``dit64`` (DiT-S/4) with DDIM-50 (600), batch 8, three batches each,
   no separate-tensor or GroupNorm launch; 5e. ``tiled_flow_sample`` of
   512 x 512 scenes with the ``dit256`` denoiser (3 x 3 tiles at overlap
   0.5, Heun-8: 15 stitched calls, 180 K1 launches), finite; 5f. the
   sampling CLI's solvers and guidance on ``sen12mscr256`` (batch 8, two
   batches a run, img/s over the second): DDIM-50, DPM-Solver++-20
   (uniform-lambda and Karras grids), UniPC-10, image-CFG at scale 3 with
   the rescale and the interval (K1 at B16), dynamic thresholding,
   DeepCache-3 on DDIM-50 (17 full calls, 33 shallow ones that launch no
   attention), PAG (a perturbed call a step: no K1, one identity hit an
   attention block), SDEdit 0.5 from the cloudy view, then a short
   ``cli.train --posthoc_ema`` run whose snapshots feed
   ``--phema_sigma_rel`` and ``--autoguide_sigma_rel``; ``cddpm64`` with
   label-CFG on DDIM and DPM, ``cflow64`` Heun-8 with CFG and ``vpred64``
   with DPM, at their own widths; ``tiled_ddim_sample`` of a 512 px scene
   with CFG and DeepCache (one state a chunk of tiles). Every run's
   launches are asserted against the counts ``build_unet_plan`` and the
   sampler give. DPM-20 and UniPC-10 are held against the all-plain model
   from the same x_T (SOLVER_NOISE_FACTOR times the trajectory's noise
   floor, read in the same run from the forward's own kernel-vs-plain
   reading, which is first held to TOL_UNET_REL), the cost of a
   ``PowerEMA.update`` is timed beside the ``--posthoc_ema`` step, and a DeepCache partial call on a
   fresh cache against the full call (TOL_UNET_REL; whether the bits are
   the same is printed); 5g. EDM and the Brownian bridge at full width:
   K1 (B8 T256 H4 D48, B8 T64 H4 D64) and K5 at the 64 px UNet's level
   shapes (N8 and N64) against their plain versions; ``cli.train --preset
   edm64`` and ``--preset bridge64`` (base 64, mults 1/2/3/4, attention at
   ds 4 and 8, 4 heads) for EDM_BRIDGE_STEPS steps at batch 64, the K1, K4,
   K5 and weight-gradient launches as ``unet_train_expected`` gives them;
   ``cli.inference`` from each checkpoint, EDM Heun-18 (35 model calls) and
   the bridge's 50 strided steps at ``--eta 0``, two batches of 8, img/s
   over the second; from seeded weights and one start, EDM Heun-18, the
   bridge's 50 steps and ``tiled_bridge_sample`` of a 128 x 256 scene (21
   tiles of 64) through the kernels against the all-plain model
   (TOL_SOLVER_REL, the final samples' relative L2); the change-pair and
   inpainting demos of ``examples/torch`` at ``unet_clouds(64)``, DDIM-5 on
   the card, their files written; 5h. classifier guidance and DDNM
   restoration at ``synthetic64``'s width: K1 with the lse, K4 and K5 at the
   float32 classifier's shapes (B8 T256 H4 D48, B8 T64 H4 D64, its level
   shapes at N8) against their plain versions; ``cli.train_classifier
   --class_correlated`` at the preset's batch (128), 6 steps (2 K1, 2 K4, 15
   K5 each way a step); the classifier's input gradient at b8 inside
   ``torch.inference_mode()`` against the all-plain classifier (rel L2 <=
   TOL_UNET_GRAD_REL); guided DDIM-50 at b8 through ``cli.inference
   --classifier_ckpt --classifier_scale`` beside the unguided run (img/s of
   the second batch; a guided step 7 + 2 K1, 2 K4, 36 + 15 K5 forward, 15
   backward), and the guided sampler against the all-plain denoiser and
   classifier from one start (TOL_SOLVER_REL, 5g's: DDIM eta 0 on the same
   64 px UNet, so the same carried error, and a float32 gradient that parts
   from plain's by about 1e-7); ``cli.restore`` sr4, inpaint and colorize on
   ``synthetic64`` and inpaint on ``inria64`` (whose one attention, T 64 D
   1024, launches the wide kernel), DDNM-50 at b8, each with
   ``||A(x) - y|| / ||y|| <= TOL_DDNM_RANGE`` and against the all-plain model
   from one start and the same draws (TOL_SOLVER_REL); 5i. inria64 and
   eurosat64 at ``--image_size 512``, where their middle attention (one head
   of D 1024 / 512) sees T 4096: ``cli.inference`` DDIM-WIDE_STEPS at b4
   for both, ``cli.restore --task inpaint`` at b4 and ``cli.train``
   WIDE_TRAIN_STEPS steps at b4 for inria64, one wide forward a UNet
   forward and one wide backward a step asserted; each against the
   all-plain model from the same seeded weights (a forward, TOL_UNET_REL;
   the DDIM or DDNM trajectory from one start, TOL_SOLVER_REL; a loss's
   gradients at b2, TOL_UNET_GRAD_REL); 5j. ``--no_bf16`` at 256 px: the
   float32 kernel (attention_f32_sm90.cu, three-term TF32 on the tensor
   cores) at B8 T4096 H8 D48 and B8 T1024 H8 D64 forward with the lse and
   backward against plain, beside the FMA kernels it replaced and SDPA, at
   unit-normal inputs held to TOL and TOL_ATTN_L2 in float32 (backward
   TOL_BWD), a planted single-term TF32 variant caught by TOL_ATTN_L2, the
   backward's bits the same on a repeat; then ``sen12mscr256`` at full width
   and depth in float32, batch 8: ``cli.inference --no_bf16`` DDIM-F32_STEPS
   (11 float32 forward launches a UNet forward, none of the FMA kernels) and
   ``cli.train --no_bf16`` F32_TRAIN_STEPS steps (11 float32 backward
   launches a step), each against the all-plain float32 model from the same
   seeded weights (a forward, TOL_UNET_REL; the DDIM trajectory,
   TOL_SOLVER_REL; a loss's gradients at b2, TOL_UNET_GRAD_REL); img/s,
   steps/s and the device's ms a forward and a loss and backward (single
   readings); 5k. the few-step families: the forward-mode rules of
   GroupNormFn (the kernel's forward, the tangent from its statistics; at
   the 64 px UNet's level shapes at N64 with FiLM tangents, and in float32)
   and Conv3x3Fn against ``torch.func.jvp`` of their plain versions (TOL_GN,
   TOL_JVP_CONV), K1 with the lse, K4 and K5 at ``synthetic64``'s b128
   distillation shapes; one step of each distillation loss against the
   all-plain model on the same draws (ReFlow on ``latent256``'s DiT-B/4 at
   b32, consistency and progressive on ``synthetic64`` at b128: 3 forwards
   and 1 backward a step, guided on ``cddpm64`` and ``cflow64`` at b64;
   TOL_UNET_REL for the loss, TOL_UNET_GRAD_REL for the gradients); then
   ``cli.distill --method reflow`` on ``latent256`` at full width (Heun-8
   couplings, FEW_STEPS re-fit steps) and ``cli.inference --sampler flow
   --flow_method euler --sampler_steps 1`` decoding through a seeded first
   stage; ``--method consistency`` and ``progressive`` on ``synthetic64``,
   then ``--sampler cm`` at 1 and 2 steps and ``pd`` at 2 beside the
   teacher's DDIM-50, each student's final samples against the all-plain
   model from one start (TOL_SOLVER_REL); ``--method guided`` on ``cddpm64``
   and ``cflow64``; MeanFlow: ``meanflow64`` and ``cmeanflow64``, the
   training step's ``u`` and ``du/dt`` (one ``torch.func.jvp`` through the
   kernels, attention pinned to the plain version) against all-plain
   (TOL_UNET_REL), its loss and gradients too, ``cli.train`` MF_TRAIN_STEPS
   steps at b64 (K5 forward and backward at every GroupNorm, the routed
   weight gradients, no attention launch) and ``cli.inference`` at 1 and 2
   steps, MeanFlow-1's samples against all-plain. Every run's launches are
   asserted; steps/s, img/s and the card's name and power limit printed
   (single readings);
7. the training path through the entry point: ``eo_diffusion_torch.cli.train``
   with ``sen12mscr256`` at full width and depth, batch 8, bf16, a few
   steps from seeded weights; the attention counters must rise by 11 a step
   and the GroupNorm counters by 56, the ``wgmma`` conv weight-gradient
   counter by the stride-1 3x3 convs ``wgrad_route`` gives it (every
   backward of phases 4, 7 and 7b; 0 on every sampling path); the
   checkpoint restores and the sampling entry point samples from it; 7b. the
   same entry point at ``--image_size 512``, batch 4 (attention forward and
   backward 5 + 6 a step); 7c. the SEN12MS-CR feed at full width: a tree
   of GeoTIFFs written by the script's own writer (4 scenes x 16 patches at
   256 px; s1 2 bands float32 and s2 13 bands uint16 uncompressed,
   s2_cloudy deflate with the predictor), decoded by the port's native
   library (asserted to be its own build in ``_build/``, bit for bit against
   the written rasters); the train loader alone over one epoch (ms a batch
   of 8 at num_workers 0 and 8); ``cli.train --dataset sen12mscr
   --data_root`` at batch 8 for two epochs (12 steps; the first batch on the
   card equal to the loader's, the launches as in phase 7), its steady
   steps/s, step alone and with the feed, beside phase 7's; ``cli.inference``
   DDIM-4 from its checkpoint on the test split's cloudy views; the device
   cache's gather on the card against numpy; 7d. ``cli.train --preset
   dit256`` at full width and depth, batch 16, bf16, 8 steps (K1 with lse
   and K4 12 a step each, nothing else), its checkpoint restored and sampled
   by ``cli.inference --sampler flow`` (Heun-8), then ``flow64``, ``dit64``
   and ``inria64`` (the wide kernels both ways) for 4 steps each, the
   launches as their forwards give them;
   7e. evaluation: ``cli.inference --metrics --samples_fid`` on 7c's
   checkpoint and test split, ``metrics.txt`` against SSIM/PSNR recomputed
   on the CPU from the same samples; ``cli.evaluate --extractor offline``
   over the ground truth's and the samples' PNGs; the FeatureCNN of
   ``gallery/eval_extractor256.npz``, the random projection and InceptionV3
   at 299 px, batch 8, seeded weights, each on the card against the CPU;
   7f. ``cli.train --preset latent256-cr`` at full width and depth, batch
   32: the float32 first stage trains LATENT_AE_STEPS steps (6 GroupNorm
   launches each way a step, nothing else) and is saved under ``ae/``, then
   DiT-B/4 trains LATENT_DIT_STEPS steps on its latents (K1 with the lse 12,
   K4 12, GroupNorm forward 6, GroupNorm backward and weight-gradient
   kernels 0 a step), ms a step of each stage; the checkpoint and ``ae/``
   restore, and ``cli.inference --sampler flow`` (Heun-8, ``--metrics``)
   samples two batches of 8 of the test split's cloudy views and decodes
   them (180 K1 and 6 GroupNorm launches a batch), img/s;
8. the W8A8 attention probe (``eo_diffusion_torch.tools.probe_int8_attn``)
   once: the int8 core's error, its time beside the bf16 kernels' and the
   Amdahl share of a DiT-B/4 call at the latent256 shape;
8b. the 3x3 conv weight-gradient kernels against their plain version: the
   ``mma.sync`` body at the JAX tool's B8 256 x 256 C128 -> 128, the UNet's
   input conv C 6 -> 128 and output conv 128 -> 3, a ragged shape and a small
   f32 one, the ``wgmma``/TMA body at its five shapes (WGRAD_SM90_CASES: the
   same bits on a repeat) and its nine taps held apart by delta inputs
   (exact); then their tool (``eo_diffusion_torch.tools.prototype_wgrad_kernel
   --sites unet256``) once: both bodies against cuDNN's conv weight ``.grad``
   at all 49 stride-1 3x3 sites of a 256 px training backward, with
   cuDNN's time and the route's pick at each; the transposed-output attention
   kernel against its plain version (B8 T4096 H8 D48 bf16, a ragged f32
   case); the two attention-probe tools (``probe_attn_matmuls``, which holds
   the matmul probe kernel against its plain version in the probe's seven
   forms, and ``probe_packed_pv``) once each;
8c. the softmax-orientation probes (statistics along rows and columns, the
   transpose, the two hybrid attentions) and the attention variants (A-D,
   the tile sweep of B, the fused-layout route through K1) against their
   plain versions at a ragged shape (T 1000, D 40), then their four tools
   (``probe_softmax_orient --extra``, ``profile_attn_variants``,
   ``profile_attn_variants2``, ``profile_attn_fusedlayout``) once each at
   B8 T4096 H8 D48, which hold them against their plain versions there;
9. print the ``{"kernels": [...]}`` line, the card line and, last, the
   ``{"ok": true, ...}`` line.

Phase 3 also holds the int8 attention kernel against its plain version (B32
H12 T256 D64 bf16, the probe's shape, and a smaller f32 one) and times the
fused-qkv kernel at the DiT's shapes; since the latent stack, K1 with the
lse and K4 at B32 T256 H12 D64 (a DiT-B/4 training step at batch 32), K1
at B8 (phase 7f's sampling batch), and the GroupNorm kernels in float32
with SiLU at the first stage's three site shapes (HW 65536 C128, HW 16384
C256, HW 4096 C512) at N32 (training) and N8 (sampling), timed beside
``F.group_norm`` and beside ``F.silu(F.group_norm(...))``; and K1 at B16
T4096 H8 D48 and B16 T1024 H8 D64 and K5 at N16 at the clouds UNet's level
shapes (phase 5f's CFG-doubled batch). Phase 4c holds a
DiT-B/8 forward at 256 px and a DiT-B/4 call at the latent256 shape against
the all-plain model.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from eo_diffusion_torch.cli import inference as cli
from eo_diffusion_torch.cli import train as cli_train
from eo_diffusion_torch.cli.presets import build_denoiser, get_preset
from eo_diffusion_torch.models.dit import DiT, DiTConfig, dit_b
from eo_diffusion_torch.models.unet import UNet, build_unet_plan, unet_clouds
from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.cli import evaluate as cli_evaluate
from eo_diffusion_torch.core.schedules import make_ddim_schedule
from eo_diffusion_torch.diffusion.deepcache import deepcache_model_fn
from eo_diffusion_torch.diffusion.edit import sdedit_plan
from eo_diffusion_torch.diffusion.flow import FlowMatching
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
from eo_diffusion_torch.diffusion.bridge import BrownianBridge
from eo_diffusion_torch.diffusion.edm import EDMProcess
from eo_diffusion_torch.diffusion.tiled import (tiled_bridge_sample, tiled_ddim_sample,
                                                tiled_flow_sample)
from eo_diffusion_torch.models.autoencoder import ConvAutoencoder
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.ops import attn_probes as AP
from eo_diffusion_torch.ops import attn_variants as AV
from eo_diffusion_torch.ops import conv_wgrad as CW
from eo_diffusion_torch.ops import group_norm as G
from eo_diffusion_torch.ops import int8_attention as I8
from eo_diffusion_torch.ops import softmax_probes as SP
from eo_diffusion_torch.tools import (probe_attn_matmuls, probe_int8_attn, probe_packed_pv,
                                      probe_softmax_orient, profile_attn_fusedlayout,
                                      profile_attn_variants, profile_attn_variants2,
                                      prototype_wgrad_kernel)
from eo_diffusion_torch.tools.probe_packed_pv import attention_errors, planted_faults
from eo_diffusion_torch.tools.timing import (PEAK_BF16, PEAK_BYTES_PER_S, PEAK_F32, PEAK_INT8,
                                             PEAK_TF32X3, card_line, cuda_ms, queued_ms)
from eo_diffusion_torch.train import ae_trainer as AET
from eo_diffusion_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from eo_diffusion_torch.train.posthoc_ema import PowerEMA
from eo_diffusion_torch.weights import randomize_parameters

PEAK_FLOPS = {torch.bfloat16: PEAK_BF16, torch.float32: PEAK_F32}
def attention_peak(dtype, d):
    """The operations rate of an attention row's bound: the bf16 tensor
    cores; in float32 the three-term TF32 rate up to D 128 (attention_f32_sm90.cu
    runs every product as three TF32 products on the tensor cores) and the
    FMA units above (the wide kernels' float32 path)."""
    if dtype == torch.bfloat16:
        return PEAK_BF16
    return PEAK_TF32X3 if d <= 128 else PEAK_F32
# kernel vs plain (plain computes in f32 from the same inputs, then rounds to
# the input dtype): |kernel - plain| <= TOL * max(1, |plain|) elementwise.
# bf16: both outputs round to bf16, so they may differ by one ulp (2^-7
# relative), plus p rounded to bf16 before PV in the kernel (2^-9 relative);
# f32 with TF32 off agrees to summation order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TOL_LSE = 1e-3
# UNet forward at 256 px, bf16 end to end, kernel vs plain attention
TOL_UNET_REL = 3e-2
# backward kernel vs plain (one recipe: p and ds rounded to the input dtype,
# f32 accumulation, one final rounding): |kernel - plain| <= TOL_BWD *
# max(rms, |plain|) elementwise, rms over dq, dk and dv together. bf16: an
# output ulp (2^-8) plus the ulps of p and ds where an f32 value sat on a
# rounding boundary; f32: summation order and exp's last bits
TOL_BWD = {torch.bfloat16: 4e-2, torch.float32: 2e-4}
# the bf16 backward at unit-normal inputs (strict_bwd_check), also by its
# relative L2 difference over dq, dk and dv together. Kernel and plain follow
# one recipe, so they part only where an f32 value (a score, p, ds, an
# output) sits within its summation-order error of a bf16 rounding boundary:
# a rare flip of one ulp (2^-8), averaged over T terms of a sum, far below
# 1e-3. A gradient 1 % off everywhere reads 9.9e-3 and one streamed query
# tile left out of the KV pass about sqrt(BN / T) of dk and dv (0.1 at T
# 4096): the limit sits halfway (in log) between the readings and the first
TOL_BWD_L2 = 5e-3
# UNet loss + backward at 256 px, bf16 end to end, kernel vs plain attention:
# relative L2 over all parameter gradients. The two attentions differ by bf16
# ulps in every block, and the difference crosses the bf16 layers both ways
TOL_UNET_GRAD_REL = 1e-2
# the clouds UNet's 11 attention launches a forward (5 blocks at ds 4, 6 at
# ds 8) by image size, (fused-qkv entry, separate-tensor entry):
# ds 4 / ds 8 give T 256 / 64 at 64 px and 4096 / 1024 at 256 px (all
# fused-qkv), 9216 / 2304 at 384 (neither), 16384 / 4096 at 512 (ds 8 only)
ROUTES = {64: (11, 0), 256: (11, 0), 384: (0, 11), 512: (6, 5)}
# a forward's attention launches by kernel for each UNet the script drives,
# by (image size, base width, channel mults, attention resolutions). The
# (T, D) of its blocks (UNetPlan.attention_shapes) and the kernels' ranges
# give them: the fused-qkv entry K1 takes D <= 128 at these T; the wide
# kernel takes D above 256 (bf16) at every T, so inria64's and eurosat64's
# one attention (the middle block, one head of D 1024 / 512: T 64 at 64 px,
# 4096 at 512 px) launches it
UNET_ATTN = {
    (64, 64, (1, 2, 3, 4), (4, 8)): {"attn_fwd": 7},      # synthetic64, flow64, edm64, ...
    (64, 128, (1, 2, 3, 4), (4, 8)): {"attn_fwd": 11},    # unet_clouds(64)
    (256, 128, (1, 2, 3, 4), (4, 8)): {"attn_fwd": 11},   # sen12mscr256
    (64, 128, (1, 2, 4, 8), ()): {"wide_fwd": 1},         # inria64
    (512, 128, (1, 2, 4, 8), ()): {"wide_fwd": 1},        # inria64 at 512 px (T 4096)
    (512, 128, (1, 2, 3, 4), ()): {"wide_fwd": 1},        # eurosat64 at 512 px
}
# a float32 UNet's attention launches go to the float32 kernel's counters
# (attention_f32_sm90.cu, through either entry); the wide kernels keep theirs
F32_KEYS = {"attn_fwd": "attn_fwd_f32", "flash_fwd": "flash_fwd_f32"}
# a forward counter's backward counterpart (one backward launch a forward one)
BWD_OF = {"attn_fwd": "attn_bwd", "flash_fwd": "flash_bwd", "wide_fwd": "wide_bwd",
          "attn_fwd_f32": "attn_bwd_f32", "flash_fwd_f32": "flash_bwd_f32", "gn_fwd": "gn_bwd"}
# clouds UNet: 22 ResBlocks x 2 norms, 11 attention norms, the output norm
GN_PER_FORWARD = 56
# GroupNorm kernel vs plain (both f32 from the same inputs, one rounding):
# forward |kernel - plain| <= TOL_GN * max(1, |plain|); bf16 one output ulp
# (2^-7 relative) where the two f32 values straddle a rounding boundary, f32
# the order of the sums (the mean-100 case moves the mean by ulps of 100).
# Backward: dx the same against max(rms of dx, |plain|); dgamma and dbeta,
# f32 sums over HW in another order, TOL_GN_PARAMS of max(rms, |plain|)
TOL_GN = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
TOL_GN_PARAMS = 1e-3
# the kernel's statistics against float64: the mean in units of the group's
# std and rstd relative, both <= TOL_GN_STATS. The kernel sums in f32 about
# a shift and combines chunks with Chan's formula: readings about 1e-7 at
# unit inputs and 1.5e-5 at the mean-100 case (two ulps of 100). A chunk of
# rows lost from the combine (fraction f of the M values of a group) moves
# them by about sqrt(f / M) times a unit normal, and the largest over the
# N * G groups by about 2.5 times that: 6e-4 at level 0 (f = 1/66, M =
# 262144), 3e-3 at level 2 and 5e-3 at level 3, where the planted fault is
# asserted caught
TOL_GN_STATS = 1e-4
# f32 operations an element (not on the tensor cores): forward statistics
# and affine 5, SiLU 4 more; backward 11, SiLU's derivative 8 more
GN_OPS = {("fwd", "none"): 5, ("fwd", "silu"): 9, ("bwd", "none"): 11, ("bwd", "silu"): 19}
# fused-qkv attention launches of one DiT forward: one a block (12 blocks in
# dit256, dit64 and the probe's DiT-B/4), all at aligned T (1024 or 256)
DIT_DEPTH = 12
# the DiT sampling runs: (preset, sampler flags, model calls a batch)
DIT_RUNS = (("dit256", ["--sampler", "flow", "--flow_method", "heun", "--sampler_steps", "8"],
             15),
            ("dit256", ["--sampler", "flow", "--flow_method", "euler", "--sampler_steps", "32"],
             32),
            ("dit64", ["--sampler", "ddim", "--sampler_steps", "50"], 50))
# conv weight gradient, kernel vs plain: |kernel - plain| <= TOL_WGRAD *
# max|plain|. bf16 inputs: both sides sum exact products in f32, only the
# order differs (H100 readings 1.7e-5 at B8 256^2 C128, 1.3e-4 at worst over
# the UNet's 49 sites), while one dy tile lost from a split's range moves
# dW by about 3.5e-3 at B8 256^2; f32 inputs: each product rounds once
# more, same argument (reading 2e-7)
TOL_WGRAD = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
# kernel vs cuDNN's conv weight .grad at the UNet's sites: cuDNN rounds its
# result to bf16 once (half an ulp, 2^-9 relative), besides the order of sums
TOL_WGRAD_CUDNN = 1e-2
# the matmul probe, kernel vs plain: exact bf16 products summed in f32 in
# another order, |diff| <= TOL_PROBE * max|plain|
TOL_PROBE = 1e-5
# the softmax statistics, kernel vs plain: the same f32 terms summed in another
# order (and exp's last bits), |diff| <= TOL_STATS * max|plain|; the transpose
# doubles bf16 values in bf16 on both sides: bit-exact
TOL_STATS = 1e-5
# the attention probes (the transposed output, the hybrids, the variants A-D
# and the fused-layout route), kernel vs plain (probe_packed_pv's
# attention_errors): at unit-normal inputs about T/e keys share the weight,
# so |plain| sits far below 1 (rms 0.026 at T 4096, D 48) and a floor of 1
# would make TOL an absolute limit about the size of an output. Each is held
# elementwise to TOL of max(rms, |plain|), which one dropped K/V stage breaks
# (about sqrt(64/T) of rms), and by its relative L2 difference to
# TOL_ATTN_L2, which a fault that scales every output breaks (l off by 1 %:
# 1e-2). bf16: one output ulp (2^-8..2^-7 of the value) where the two f32
# values straddle a rounding, and p rounded at another running max (B, the
# hybrids, K1; A, C and D round p from the final statistics as plain does);
# f32 the order of sums. Every run also reads the two faults, planted on the
# kernel's output and through the plain version, and asserts the limits
# catch them (check_faults_caught)
TOL_ATTN_L2 = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
# stride-1 3x3 convs of the clouds UNet (sen12mscr256): 49 sites
WGRAD_SITES = 49
# the wgmma weight-gradient body against plain: the JAX tool's shape, sites
# of levels 0-2 of a 256 px step, a ragged shape
WGRAD_SM90_CASES = [(8, 256, 256, 128, 128), (8, 256, 256, 256, 128), (8, 128, 128, 256, 256),
                    (8, 64, 64, 384, 384), (3, 20, 27, 40, 24)]
# its nine taps held apart (prototype_wgrad_kernel.delta_check): exact
WGRAD_DELTA_CASES = [(2, 20, 37, 64, 64), (2, 16, 16, 128, 64), (1, 9, 33, 64, 24),
                     (3, 24, 40, 72, 136)]
TRAIN_STEPS = 8
TRAIN_STEPS_512 = 6
# phase 7d: dit256 training at batch 16 for TRAIN_STEPS steps, then flow64
# and dit64 through the same entry point for SHORT_STEPS steps at batch 16
DIT_TRAIN_BATCH = 16
SHORT_STEPS = 4
# phase 7e: the card's metrics against the CPU's. SSIM/PSNR of the sampling
# CLI against the port's functions on the CPU from the same samples: f32
# sums in another order; the extractors (FeatureCNN, InceptionV3, the
# random projection) card against CPU with TF32 off: |card - cpu| <=
# TOL_EVAL * max|cpu|
TOL_METRICS = 1e-5
TOL_EVAL = 1e-4
STEPS_512 = 20  # DDIM steps of the 512 px whole-scene and tiled runs
# phase 5i: inria64 and eurosat64 at 512 px (the wide kernels at T 4096):
# DDIM / DDNM steps and the batch of the CLIs' runs, training steps (steps/s
# over the last two), the batch of the gradient check against all-plain
WIDE_STEPS = 10
WIDE_BATCH = 4
WIDE_TRAIN_STEPS = 4
WIDE_GRAD_BATCH = 2
# phase 7c: a SEN12MS-CR tree of SEN12_SCENES x SEN12_PATCHES triplets at
# 256 px (s1: 2 bands float32; s2, s2_cloudy: 13 bands uint16), 54 of them in
# the train split (batches of 8: 6 a epoch), 10 in the test split
SEN12_SCENES, SEN12_PATCHES, SEN12_SIZE = 4, 16, 256
SEN12_EPOCHS = 2
# latent256-cr, the production LDM recipe (phases 3, 4e, 5e, 7f): a float32
# f4 first stage at 256 px (base 128: GroupNorm + SiLU sites at HW 65536 /
# 16384 / 4096 with C 128 / 256 / 512, each once in the encoder and once in
# the decoder) and DiT-B/4 on the 64 x 64 x 4 latent grid (T 256, D 64, 12
# heads), batch 32
LATENT_BATCH = 32
LATENT_SAMPLE_BATCH = 8  # phase 7f's cli.inference batch: encode, DiT, decode at N8
AE_GN_SITES = ((65536, 128), (16384, 256), (4096, 512))
AE_NORMS = 6  # GroupNorm launches of one encode + decode (3 + 3)
# phase 7f: first-stage steps, then denoiser steps, through cli.train
LATENT_AE_STEPS = 8
LATENT_DIT_STEPS = 6
# the first stage, kernels vs the all-plain AE (phase 4e), float32 end to end
# with TF32 off: the GroupNorm kernel's statistics part from plain's in the
# order of their sums only (about 1e-7 of the std, phase 3), and the convs
# are cuDNN's on both sides, so the decoded output, the loss and the
# parameter gradients part by little more than f32 rounding: relative L2
# <= TOL_AE_REL
TOL_AE_REL = 1e-4
# phase 5e: tiled_flow_sample of TILED_FLOW_SCENES 512 x 512 scenes with the
# dit256 denoiser (3 x 3 tiles at overlap 0.5), Heun-8: 15 stitched calls
TILED_FLOW_SCENES = 2
# phase 5f: DPM-Solver++-20 and UniPC-10 at 256 px b8, kernels against the
# all-plain model from the same x_T: the relative L2 of the final samples.
# With random weights the UNet carries a small change of x far along a
# trajectory (on an H100 at 700 W UniPC-10 read 5.2e-2 and DPM-20 1.8e-2,
# one forward 1.0e-2), so the limit is measured
# in the same run: the plain model's trajectory against itself with every
# model output given random relative noise of the size one kernel forward
# parts from plain, that reading first held to TOL_UNET_REL (so the limit is
# bounded by a fixed tolerance, not by the error under test). Kernels that
# round differently from plain move the trajectory by about that floor; the
# factor leaves room for their differences being structured rather than
# random
SOLVER_NOISE_FACTOR = 3
PHEMA_STEPS = 4  # phase 5f: cli.train --posthoc_ema steps (snapshots at 2 and 4)
# the clouds UNet's GroupNorm level shapes at 256 px (the attention norm at
# level 2 without SiLU), phase 3's N16 rows
CFG_GN_SITES = ((65536, 128, "silu"), (16384, 256, "silu"), (4096, 384, "none"),
                (1024, 512, "silu"))

# phase 5g: EDM and the Brownian bridge on the 64 px UNet of edm64 and
# bridge64 (base 64, mults 1/2/3/4, attention at ds 4 and 8, 4 heads: K1 at
# T256 D48 and T64 D64), trained through cli.train at the presets' batch
# and sampled through cli.inference at b8: EDM Heun-18 (35 model calls, the
# last step Euler), the bridge's 50 strided posterior steps at eta 0
EDM_BRIDGE_BATCH = 64
EDM_BRIDGE_STEPS = 4
EDM_HEUN_STEPS, EDM_HEUN_CALLS = 18, 35
BRIDGE_STEPS = 50
# kernels against the all-plain model from the same weights and start: the
# relative L2 of the final samples (phase 5f's original solver limit, one
# forward's limit TOL_UNET_REL carried to the end of a trajectory)
TOL_SOLVER_REL = 3e-2
# tiled_bridge_sample: one 128 x 256 scene in 3 x 7 tiles of 64 at overlap
# 0.5, one model call a step over the 21 tiles
TILED_BRIDGE_SCENE = (128, 256)
TILED_BRIDGE_STEPS = 20
# the 64 px UNet's GroupNorm level shapes (the attention norm at level 2
# without SiLU), phase 5g's rows at N8 (sampling) and N64 (training)
EDM64_GN_SITES = ((4096, 64, "silu"), (1024, 128, "silu"), (256, 192, "none"), (64, 256, "silu"))
# the demos at their full-width 64 px config (unet_clouds(64)), DDIM steps
DEMO_DDIM_STEPS = 5

# phase 5h: classifier guidance and DDNM restoration on synthetic64 (base 64,
# mults 1/2/3/4, attention at ds 4 and 8, 4 heads). The EncoderUNet
# classifier computes in float32, as the JAX package's does: K1 (with the
# lse) and K4 take their float32 bodies at B8 T256 H4 D48 and B8 T64 H4 D64,
# and its 3x3 convs keep cuDNN's weight gradient (wgrad_route is bf16 only).
# One classifier forward: 2 K1 and 15 K5 (six ResBlocks with two norms, two
# attention norms, out_norm); its input gradient mirrors them (2 K4, 15 K5)
CLF_PRESET = "synthetic64"
CLF_TRAIN_STEPS = 6  # at the preset's own batch (128)
CLF_EVAL_N = 256  # cli.train_classifier's default held-out set, one forward a level
CLF_ATTN, CLF_NORMS = 2, 15
CLF_SCALE = 2.0
GUIDED_STEPS = 50  # DDIM-50 at b8, eta 0, two batches, img/s over the second
RESTORE_STEPS = 50  # DDNM's DDIM steps at b8, eta 0.85
# DDNM's final projection makes A(x) = y up to float32 rounding
TOL_DDNM_RANGE = 1e-5
# phase 5j: --no_bf16 at 256 px (sen12mscr256, b8, float32 end to end): DDIM
# steps of cli.inference (two batches, img/s over the second), cli.train
# steps, and the batch of the gradient check against the all-plain float32
# model (its backward holds five blocks' [B, 8, 4096, 4096] float32
# softmaxes)
F32_STEPS = 10
F32_TRAIN_STEPS = 4
F32_GRAD_BATCH = 2
# phase 5k: the few-step families. Consistency and progressive distillation
# on synthetic64 at its batch (128), the x0 pool one batch of teacher
# DDIM-FEW_POOL_STEPS samples; ReFlow on latent256 (b32); guidance
# distillation on cddpm64 and cflow64 and MeanFlow on meanflow64 and
# cmeanflow64 at their b64; FEW_STEPS student steps a method (a round),
# MF_TRAIN_STEPS cli.train steps; the samplers at FEW_SAMPLE_BATCH, two batches
FEW_PRESET = "synthetic64"
FEW_BATCH = 128
FEW_POOL_STEPS = 10
FEW_STEPS = 4
MF_BATCH = 64
MF_TRAIN_STEPS = 4
FEW_SAMPLE_BATCH = 8
# Conv3x3Fn's forward-mode tangent against the plain conv's: the same cuDNN
# bf16 conv of the tangent on both sides, so the bound is the wgrad's
TOL_JVP_CONV = 1e-3


def attention_case(b, t, heads, d, dtype, new_order, gen, with_lse=False):
    """Kernel vs plain on one shape; returns a result row."""
    c = heads * d
    qkv = torch.randn(b, t, 3 * c, generator=gen, device="cuda")
    q, k, _ = A.split_qkv(qkv, heads, new_order)
    q.mul_(2.0)  # sharper softmax than unit inputs: outputs track single keys
    k.mul_(2.0)
    qkv = qkv.to(dtype)
    out = A.qkv_attention_cuda(qkv, heads, new_order, return_lse=with_lse)
    ref = A.attention_from_qkv(qkv, heads, new_order, impl="plain", return_lse=with_lse)
    torch.cuda.synchronize()
    if with_lse:
        (out, lse), (ref, ref_lse) = out, ref
        lse_err = (lse - ref_lse).abs().max().item()
        assert lse_err <= TOL_LSE, f"lse error {lse_err} > {TOL_LSE}"
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    scaled = (diff / ref.float().abs().clamp(min=1.0)).max().item()
    assert math.isfinite(err) and scaled <= TOL[dtype], (
        f"kernel vs plain at B{b} T{t} H{heads} D{d} {dtype}: {scaled} > {TOL[dtype]}")

    strict = None
    what = f"fused-qkv entry at B{b} T{t} H{heads} D{d} new_order={new_order}"
    if dtype == torch.bfloat16 and not with_lse:  # the wgmma/TMA body, unit-normal inputs
        unit = torch.randn(b, t, 3 * c, generator=gen, device="cuda").to(dtype)
        strict = strict_check(lambda: A.qkv_attention_cuda(unit, heads, new_order).reshape(
            b, t, heads, d), *A.split_qkv(unit, heads, new_order), chunk=b, what=what)
        del unit
    elif dtype == torch.float32:  # the three-term TF32 kernel, unit-normal inputs
        strict = f32_strict_check(b, t, heads, d, new_order, what)

    reps = 20 if t >= 1024 else 100
    kernel_ms = cuda_ms(lambda: A.qkv_attention_cuda(qkv, heads, new_order,
                                                     return_lse=with_lse), reps)
    mma_ms = cuda_ms(lambda: A.qkv_attention_mma_cuda(qkv, heads, new_order,
                                                      return_lse=with_lse), reps)
    queued = {}
    if dtype == torch.float32 and t <= 256:  # back to back the calls time the host too
        queued = {"queued_ms": queued_ms(lambda: A.qkv_attention_cuda(
            qkv, heads, new_order, return_lse=with_lse)),
                  "mma_body_queued_ms": queued_ms(lambda: A.qkv_attention_mma_cuda(
                      qkv, heads, new_order, return_lse=with_lse))}
    plain_ms = cuda_ms(lambda: A.attention_from_qkv(qkv, heads, new_order, impl="plain"),
                       3 if t >= 1024 else 20, warmup=1)
    q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous() for x in A.split_qkv(qkv, heads, new_order))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                scale=1.0 / math.sqrt(d)), reps)
    if queued:
        queued["library_queued_ms"] = queued_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0 / math.sqrt(d)))
    flops = 4.0 * b * heads * t * t * d
    nbytes = qkv.element_size() * b * t * 4 * c + (4 * b * heads * t if with_lse else 0)
    bound_ms = max(flops / attention_peak(dtype, d), nbytes / PEAK_BYTES_PER_S) * 1e3
    row = {"shape": f"B{b} T{t} H{heads} D{d}", "dtype": str(dtype).split(".")[-1],
           "new_order": new_order, "max_abs_err": err, "max_scaled_err": scaled,
           "unit_normal": strict, "kernel_ms": kernel_ms, "mma_body_ms": mma_ms, **queued,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / attention_peak(dtype, d) >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    if with_lse:
        row["lse_max_abs_err"] = lse_err
    print("attention " + json.dumps(row), flush=True)
    return row


def attention_bwd_case(b, t, heads, d, dtype, new_order, gen, ugen):
    """Backward kernel vs plain on one shape (o and lse from the forward
    kernel), and the mma.sync body on the same tensors; the unit-normal
    check draws from ``ugen``. Returns a result row."""
    c = heads * d
    qkv = torch.randn(b, t, 3 * c, generator=gen, device="cuda")
    q, k, _ = A.split_qkv(qkv, heads, new_order)
    q.mul_(2.0)
    k.mul_(2.0)
    qkv = qkv.to(dtype)
    dout = torch.randn(b, t, c, generator=gen, device="cuda").to(dtype)
    out, lse = A.qkv_attention_cuda(qkv, heads, new_order, return_lse=True)
    dqkv = A.qkv_attention_bwd_cuda(qkv, out, lse, dout, heads, new_order)
    shape = (b, t, heads, d)
    plain = lambda: A.reference_attention_bwd(*A.split_qkv(qkv, heads, new_order),
                                              out.reshape(shape), lse, dout.reshape(shape))
    ref = plain()
    torch.cuda.synchronize()
    rms = torch.stack([r.float() for r in ref]).pow(2).mean().sqrt().item()
    err = scaled = 0.0
    for got, want in zip(A.split_qkv(dqkv, heads, new_order), ref):
        diff = (got.float() - want.float()).abs()
        err = max(err, diff.max().item())
        scaled = max(scaled, (diff / want.float().abs().clamp(min=rms)).max().item())
    mma_scaled = max_scaled_bwd_err(
        A.split_qkv(A.qkv_attention_bwd_mma_cuda(qkv, out, lse, dout, heads, new_order), heads,
                    new_order), ref, rms)
    assert math.isfinite(err) and scaled <= TOL_BWD[dtype], (
        f"backward kernel vs plain at B{b} T{t} H{heads} D{d} {dtype}: {scaled} > "
        f"{TOL_BWD[dtype]} (the mma.sync body on the same tensors: {mma_scaled})")
    del ref

    strict = None
    if dtype == torch.float32:  # the three-term TF32 kernel, unit-normal inputs
        strict = f32_strict_bwd_check(b, t, heads, d, new_order,
                                      f"fused-qkv backward at B{b} T{t} H{heads} D{d}")
    if dtype == torch.bfloat16:  # the wgmma/TMA body, unit-normal inputs
        unit = torch.randn(b, t, 3 * c, generator=ugen, device="cuda").to(dtype)
        planes = A.split_qkv(unit, heads, new_order)
        strict = strict_bwd_check(
            lambda o, l, g: A.split_qkv(A.qkv_attention_bwd_cuda(
                unit, o.reshape(b, t, c), l, g.reshape(b, t, c), heads, new_order), heads,
                new_order), *planes, hchunk=heads,
            what=f"fused-qkv backward at B{b} T{t} H{heads} D{d} new_order={new_order}",
            gen=ugen)
        del unit, planes

    big = t >= 1024
    reps = 10 if big else 50
    kernel_ms = cuda_ms(lambda: A.qkv_attention_bwd_cuda(qkv, out, lse, dout, heads, new_order),
                        reps)
    mma_ms = cuda_ms(lambda: A.qkv_attention_bwd_mma_cuda(qkv, out, lse, dout, heads,
                                                          new_order), reps)
    plain_ms = cuda_ms(plain, 2 if big else 10, warmup=1)
    queued = {}
    if t <= 256:  # the 64 px shapes, where back-to-back calls time the host too
        queued = {"queued_ms": queued_ms(lambda: A.qkv_attention_bwd_cuda(
            qkv, out, lse, dout, heads, new_order)),
                  "mma_body_queued_ms": queued_ms(lambda: A.qkv_attention_bwd_mma_cuda(
                      qkv, out, lse, dout, heads, new_order))}
    if dtype == torch.float32:  # no atomics: the same bits on every call
        again = A.qkv_attention_bwd_cuda(qkv, out, lse, dout, heads, new_order)
        assert torch.equal(again, dqkv), "the float32 backward's bits moved between calls"
    # the library's yardstick: the backward of scaled_dot_product_attention alone
    q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous().requires_grad_()
                  for x in A.split_qkv(qkv, heads, new_order))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0 / math.sqrt(d))
    g4 = dout.reshape(shape).permute(0, 2, 1, 3).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True),
                         10 if big else 50)
    if queued:
        queued["library_queued_ms"] = queued_ms(
            lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True))
    flops = 10.0 * b * heads * t * t * d
    # q, k, v, o, do read and dq, dk, dv written once each, plus the lse
    nbytes = qkv.element_size() * b * t * 8 * c + 4 * b * heads * t
    bound_ms = max(flops / attention_peak(dtype, d), nbytes / PEAK_BYTES_PER_S) * 1e3
    row = {"shape": f"B{b} T{t} H{heads} D{d}", "dtype": str(dtype).split(".")[-1],
           "new_order": new_order, "grad_rms": rms, "max_abs_err": err,
           "max_scaled_err": scaled, "mma_body_max_scaled_err": mma_scaled,
           "unit_normal": strict, "kernel_ms": kernel_ms, "mma_body_ms": mma_ms, **queued,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / attention_peak(dtype, d) >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    print("attention_bwd " + json.dumps(row), flush=True)
    return row


def f32_strict_check(b, t, heads, d, new_order, what):
    """The float32 kernel (three-term TF32) at unit-normal inputs through the
    fused entry against plain with the probes' limits in float32
    (check_attention: TOL of max(rms, |plain|), TOL_ATTN_L2 of relative L2),
    and at D 48 and 64 the planted fault: the single-term variant (plain TF32)
    on the same inputs must break TOL_ATTN_L2. Draws from a generator of its
    own, so every check after it keeps its draws. Returns the errors."""
    sgen = torch.Generator(device="cuda").manual_seed(1900 + t + d)
    unit = torch.randn(b, t, 3 * heads * d, generator=sgen, device="cuda")
    q, k, v = A.split_qkv(unit, heads, new_order)
    got = A.qkv_attention_cuda(unit, heads, new_order).reshape(b, t, heads, d)
    ref = plain_fwd(q, k, v, 1 if t >= 4096 else b, with_lse=False)
    torch.cuda.synchronize()
    row = attention_errors(got, ref)
    check_attention(row, torch.float32, what)
    if d in (48, 64):
        row["one_term"] = attention_errors(A._attention_f32_one_term(q, k, v), ref)
        assert row["one_term"]["rel_l2_err"] > TOL_ATTN_L2[torch.float32], (what, row)
    del unit, got, ref
    torch.cuda.empty_cache()
    return row


def f32_strict_bwd_check(b, t, heads, d, new_order, what):
    """The float32 backward at unit-normal inputs through the fused entry
    against plain (dq, dk, dv together): TOL_BWD of max(rms, |plain|), its
    relative L2 recorded beside TOL_ATTN_L2; at D 48 and 64 the single-term
    variant (plain TF32) on the same inputs must break TOL_ATTN_L2. A
    generator of its own. Returns the errors."""
    sgen = torch.Generator(device="cuda").manual_seed(2900 + t + d)
    unit = torch.randn(b, t, 3 * heads * d, generator=sgen, device="cuda")
    planes = A.split_qkv(unit, heads, new_order)
    c = heads * d
    out, lse = A.qkv_attention_cuda(unit, heads, new_order, return_lse=True)
    dout = torch.randn(b, t, c, generator=sgen, device="cuda")
    shape = (b, t, heads, d)
    flat = lambda xs: torch.cat([x.flatten() for x in xs])
    got = flat(A.split_qkv(A.qkv_attention_bwd_cuda(unit, out, lse, dout, heads, new_order),
                           heads, new_order))
    want = flat(plain_bwd(*planes, out.reshape(shape), lse, dout.reshape(shape), heads))
    torch.cuda.synchronize()
    row = attention_errors(got, want)
    assert row["max_rms_scaled_err"] <= TOL_BWD[torch.float32], (what, row)
    if d in (48, 64):
        one = flat(A._attention_bwd_f32_one_term(*planes, out.reshape(shape), lse,
                                                 dout.reshape(shape)))
        row["one_term"] = attention_errors(one, want)
        assert row["one_term"]["rel_l2_err"] > TOL_ATTN_L2[torch.float32], (what, row)
    del unit, planes, got, want
    torch.cuda.empty_cache()
    return row


def make_planes(b, t, heads, d, dtype, layout, gen, sharpen=True):
    """q, k, v [B, T, H, D]: the split_qkv views of one projection in either
    head order ("legacy", "new"), or three contiguous tensors; q and k x2
    where ``sharpen``."""
    f = 2.0 if sharpen else 1.0
    if layout == "contiguous":
        q, k, v = (torch.randn(b, t, heads, d, generator=gen, device="cuda") for _ in range(3))
        q.mul_(f)
        k.mul_(f)
        return [x.to(dtype) for x in (q, k, v)]
    qkv = torch.randn(b, t, 3 * heads * d, generator=gen, device="cuda")
    q, k, _ = A.split_qkv(qkv, heads, layout == "new")
    q.mul_(f)
    k.mul_(f)
    return list(A.split_qkv(qkv.to(dtype), heads, layout == "new"))


def plain_fwd(q, k, v, chunk, with_lse=True):
    """The plain forward, ``chunk`` samples at a time (its [B, H, T, T] f32
    scores at B8 T16384 H8 would take 69 GB); the same function."""
    res = [A.reference_attention(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk],
                                 return_lse=with_lse) for i in range(0, q.shape[0], chunk)]
    if not with_lse:
        return torch.cat(res)
    return torch.cat([r[0] for r in res]), torch.cat([r[1] for r in res])


def sm90_stage(d):
    """Keys a K/V stage of the wgmma/TMA forward body at head dim d."""
    return 128 if d <= 128 else 64


def strict_check(fwd, q, k, v, chunk, what):
    """The wgmma/TMA body at unit-normal inputs against plain with the
    probes' limits (check_attention: TOL of max(rms, |plain|) elementwise,
    TOL_ATTN_L2 of relative L2), and the two planted faults (its output 1 %
    off; plain without one K/V stage of the body's, or half of T where T
    holds less than two) caught by them; q, k, v [B, T, H, D] bf16 views,
    ``fwd`` the entry under test. Returns the errors."""
    got = fwd()
    ref = plain_fwd(q, k, v, chunk, with_lse=False)
    stage = min(sm90_stage(q.shape[-1]), q.shape[1] // 2)  # T < 2 stages: half of T
    dropped = plain_fwd(q, profile_attn_variants.without_a_stage(k, stage),
                        profile_attn_variants.without_a_stage(v, stage), chunk, with_lse=False)
    torch.cuda.synchronize()
    row = {**attention_errors(got, ref), "planted_faults": planted_faults(got, ref, dropped)}
    check_attention(row, torch.bfloat16, what)
    check_faults_caught(row, what)
    del got, ref, dropped
    torch.cuda.empty_cache()
    return row


def plain_bwd(q, k, v, o, lse, do, hchunk):
    """The plain backward, one sample and ``hchunk`` heads at a time (it
    holds about five [B, H, T, T] f32 tensors); the same function."""
    b, t, h, _ = q.shape
    grads = [torch.empty_like(q) for _ in range(3)]
    lse4 = lse.reshape(b, h, t)
    for i in range(b):
        for j in range(0, h, hchunk):
            sl = (slice(i, i + 1), slice(None), slice(j, j + hchunk))
            part = A.reference_attention_bwd(q[sl], k[sl], v[sl], o[sl],
                                             lse4[i, j:j + hchunk], do[sl])
            for g, x in zip(grads, part):
                g[sl] = x
    return grads


def sm90_bwd_queries(d):
    """Queries a streamed tile of the wgmma/TMA backward's KV pass at head
    dim d."""
    return 64 if d <= 128 else 32


def check_bwd(row, what):
    """The bf16 backward's row (at unit-normal inputs) against TOL_BWD and
    TOL_BWD_L2."""
    err, l2 = row["max_rms_scaled_err"], row["rel_l2_err"]
    bf16 = torch.bfloat16
    assert math.isfinite(err) and err <= TOL_BWD[bf16] and l2 <= TOL_BWD_L2, (
        f"{what} vs plain: {err} > {TOL_BWD[bf16]} of max(rms, |plain|) or rel L2 {l2} > "
        f"{TOL_BWD_L2}")


def strict_bwd_check(bwd, q, k, v, hchunk, what, gen):
    """The wgmma/TMA backward at unit-normal inputs against plain (dq, dk, dv
    together: TOL_BWD of max(rms, |plain|) elementwise, TOL_BWD_L2 of
    relative L2), and two planted faults caught by those limits: its
    gradients 1 % off, and the KV pass without one streamed tile of queries
    (plain with those dO rows zeroed gives its dk and dv). q, k, v are
    [B, T, H, D] bf16; ``bwd(out, lse, dout)`` returns (dq, dk, dv) of the
    entry under test. Returns the errors."""
    b, t, h, d = q.shape
    out, lse = A.flash_attention_cuda(q, k, v, return_lse=True)
    dout = torch.randn(b, t, h, d, generator=gen, device="cuda").to(q.dtype)
    flat = lambda xs: torch.cat([x.flatten() for x in xs])
    got = flat(bwd(out, lse, dout))
    ref = plain_bwd(q, k, v, out, lse, dout, hchunk)
    tile = min(sm90_bwd_queries(d), t // 2)  # T < 2 tiles: half of T
    t0 = tile * (t // 2 // tile)
    dropped = dout.clone()
    dropped[:, t0:t0 + tile] = 0
    _, dk, dv = plain_bwd(q, k, v, out, lse, dropped, hchunk)
    torch.cuda.synchronize()
    want = flat(ref)
    row = {**attention_errors(got, want),
           "planted_faults": planted_faults(got, want, flat((ref[0], dk, dv)))}
    check_bwd(row, what)
    check_faults_caught(row, what, TOL_BWD[torch.bfloat16], TOL_BWD_L2)
    del got, ref, want, dropped, dk, dv, out, lse, dout
    torch.cuda.empty_cache()
    return row


def flash_case(b, t, heads, d, dtype, layout, gen, chunk=None, tag="flash_fwd"):
    """The separate-tensor forward entry vs plain (with the lse) on one
    shape, timed without the lse as sampling runs it; returns a result row
    (printed after ``tag``)."""
    q, k, v = make_planes(b, t, heads, d, dtype, layout, gen)
    chunk = chunk or b
    out, lse = A.flash_attention_cuda(q, k, v, return_lse=True)
    ref, ref_lse = plain_fwd(q, k, v, chunk)
    torch.cuda.synchronize()
    lse_err = (lse - ref_lse).abs().max().item()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    scaled = (diff / ref.float().abs().clamp(min=1.0)).max().item()
    label = f"B{b} T{t} H{heads} D{d} {layout}"
    assert math.isfinite(err) and scaled <= TOL[dtype] and lse_err <= TOL_LSE, (
        f"flash forward vs plain at {label} {dtype}: {scaled} > {TOL[dtype]} or lse {lse_err}")
    del out, lse, ref, ref_lse, diff
    torch.cuda.empty_cache()
    strict = None
    if dtype == torch.bfloat16:  # the bf16 body at unit-normal inputs
        uq, uk, uv = make_planes(b, t, heads, d, dtype, layout, gen, sharpen=False)
        strict = strict_check(lambda: A.flash_attention_cuda(uq, uk, uv), uq, uk, uv, chunk,
                              f"separate-tensor entry at {label}")
        del uq, uk, uv

    big = t >= 8192
    reps = 10 if big else 20
    kernel_ms = cuda_ms(lambda: A.flash_attention_cuda(q, k, v), reps)
    mma_ms = (cuda_ms(lambda: A.flash_attention_mma_cuda(q, k, v), reps)
              if d <= 128 else None)  # the mma.sync body takes D up to 128
    # the first wide body (T up to 1024) on the same tensors, where it applies
    old_ms = (cuda_ms(lambda: A.wide_attention_resident_cuda(q, k, v), reps)
              if tag == "wide_fwd" and t <= A._RESIDENT_MAX_T else None)
    plain_ms = cuda_ms(lambda: plain_fwd(q, k, v, chunk, with_lse=False), 2 if big else 3,
                       warmup=1)
    torch.cuda.empty_cache()
    q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0 / math.sqrt(d))
    library_ms = cuda_ms(sdpa, reps)
    # the wide kernels at short T: the device's time alone too (back to back
    # the calls are host-bound)
    device = None
    if old_ms is not None:
        device = {"kernel": queued_ms(lambda: A.flash_attention_cuda(q, k, v)),
                  "old_body": queued_ms(lambda: A.wide_attention_resident_cuda(q, k, v)),
                  "library": queued_ms(sdpa)}
    del q4, k4, v4
    flops = 4.0 * b * heads * t * t * d
    nbytes = q.element_size() * b * t * heads * d * 4  # q, k, v read, o written
    bound_ms = max(flops / attention_peak(dtype, d), nbytes / PEAK_BYTES_PER_S) * 1e3
    row = {"shape": label, "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "max_scaled_err": scaled, "lse_max_abs_err": lse_err, "unit_normal": strict,
           "kernel_ms": kernel_ms, "mma_body_ms": mma_ms, "old_body_ms": old_ms,
           "device_ms": device, "plain_ms": plain_ms, "plain_chunk": chunk,
           "library_ms": library_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if flops / attention_peak(dtype, d) >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    print(f"{tag} " + json.dumps(row), flush=True)
    return row


def max_scaled_bwd_err(got, ref, rms):
    """The largest |got - plain| / max(rms, |plain|) over dq, dk and dv."""
    return max(((a.float() - w.float()).abs() / w.float().abs().clamp(min=rms)).max().item()
               for a, w in zip(got, ref))


def flash_bwd_case(b, t, heads, d, dtype, layout, gen, ugen, hchunk, tag="flash_bwd"):
    """The separate-tensor backward entry vs plain on one shape (o and lse
    from the forward entry), and the mma.sync body on the same tensors (D up
    to 128); the unit-normal check draws from ``ugen``. Returns a result
    row (printed after ``tag``)."""
    q, k, v = make_planes(b, t, heads, d, dtype, layout, gen)
    dout = torch.randn(b, t, heads, d, generator=gen, device="cuda").to(dtype)
    out, lse = A.flash_attention_cuda(q, k, v, return_lse=True)
    got = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    plain = lambda: plain_bwd(q, k, v, out, lse, dout, hchunk)
    ref = plain()
    torch.cuda.synchronize()
    rms = torch.stack([r.float() for r in ref]).pow(2).mean().sqrt().item()
    err = scaled = 0.0
    for a, want in zip(got, ref):
        diff = (a.float() - want.float()).abs()
        err = max(err, diff.max().item())
        scaled = max(scaled, (diff / want.float().abs().clamp(min=rms)).max().item())
    label = f"B{b} T{t} H{heads} D{d} {layout}"
    mma_scaled = (max_scaled_bwd_err(A.flash_attention_bwd_mma_cuda(q, k, v, out, lse, dout),
                                     ref, rms) if d <= 128 else None)
    assert math.isfinite(err) and scaled <= TOL_BWD[dtype], (
        f"flash backward vs plain at {label} {dtype}: {scaled} > {TOL_BWD[dtype]} (the "
        f"mma.sync body on the same tensors: {mma_scaled})")
    del got, ref, diff
    torch.cuda.empty_cache()
    strict = None
    if dtype == torch.bfloat16:  # the bf16 body at unit-normal inputs
        uq, uk, uv = make_planes(b, t, heads, d, dtype, layout, ugen, sharpen=False)
        strict = strict_bwd_check(
            lambda o, l, g: A.flash_attention_bwd_cuda(uq, uk, uv, o, l, g), uq, uk, uv,
            hchunk, f"separate-tensor backward at {label}", ugen)
        del uq, uk, uv

    big = t >= 8192
    reps = 5 if big else 10
    kernel_ms = cuda_ms(lambda: A.flash_attention_bwd_cuda(q, k, v, out, lse, dout), reps)
    mma_ms = (cuda_ms(lambda: A.flash_attention_bwd_mma_cuda(q, k, v, out, lse, dout), reps)
              if d <= 128 else None)  # the mma.sync body takes D up to 128
    old_ms = (cuda_ms(lambda: A.wide_attention_bwd_resident_cuda(q, k, v, out, lse, dout), reps)
              if tag == "wide_bwd" and t <= A._RESIDENT_MAX_T else None)  # the first wide body
    plain_ms = cuda_ms(plain, 1 if big else 2, warmup=1)
    torch.cuda.empty_cache()
    q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous().requires_grad_() for x in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0 / math.sqrt(d))
    g4 = dout.permute(0, 2, 1, 3).contiguous()
    sdpa_bwd = lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True)
    library_ms = cuda_ms(sdpa_bwd, 5 if big else 10)
    # the wide kernels at short T: the device's time alone too (back to back
    # the calls are host-bound)
    device = None
    if old_ms is not None:
        device = {"kernel": queued_ms(lambda: A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)),
                  "old_body": queued_ms(
                      lambda: A.wide_attention_bwd_resident_cuda(q, k, v, out, lse, dout)),
                  "library": queued_ms(sdpa_bwd)}
    del q4, k4, v4, o4, g4
    flops = 10.0 * b * heads * t * t * d
    # q, k, v, o, do read and dq, dk, dv written once each, plus the lse
    nbytes = q.element_size() * b * t * heads * d * 8 + 4 * b * heads * t
    bound_ms = max(flops / attention_peak(dtype, d), nbytes / PEAK_BYTES_PER_S) * 1e3
    row = {"shape": label, "dtype": str(dtype).split(".")[-1], "grad_rms": rms,
           "max_abs_err": err, "max_scaled_err": scaled, "mma_body_max_scaled_err": mma_scaled,
           "unit_normal": strict,
           "kernel_ms": kernel_ms, "mma_body_ms": mma_ms, "old_body_ms": old_ms,
           "device_ms": device, "plain_ms": plain_ms, "plain_heads_a_chunk": hchunk,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / attention_peak(dtype, d) >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    print(f"{tag} " + json.dumps(row), flush=True)
    return row


def sass_census(lib):
    """Instructions of a built library by kind (cuobjdump -sass): HGMMA is
    wgmma.mma_async, HMMA mma.sync, UTMALDG a TMA tile load
    (cp.async.bulk.tensor), LDL/STL register spills."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    census = {op: sass.count(op) for op in ("HGMMA", "HMMA", "UTMALDG", "SYNCS", "LDL", "STL")}
    census["HMMA_TF32"] = sass.count("HMMA.1688.F32.TF32")  # mma.sync m16n8k8 tf32
    return census


def ptxas_report(log):
    """Registers and spills of each entry function in a build's ptxas log:
    {function: {"registers", "spill_stores", "spill_loads"}}."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            out[fn] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
        elif fn and "bytes spill stores" in line:
            parts = [p.strip().split() for p in line.split(",")]
            out[fn]["spill_stores"] = int(parts[1][0])
            out[fn]["spill_loads"] = int(parts[2][0])
        elif fn and "Used" in line and "registers" in line:
            out[fn]["registers"] = int(line.split("Used")[1].split()[0])
    return out


def reset_counts():
    A.qkv_attention_cuda.launches = A.qkv_attention_bwd_cuda.launches = 0
    A.flash_attention_cuda.launches = A.flash_attention_bwd_cuda.launches = 0
    A.qkv_attention_mma_cuda.launches = A.flash_attention_mma_cuda.launches = 0
    A.qkv_attention_bwd_mma_cuda.launches = A.flash_attention_bwd_mma_cuda.launches = 0
    A.wide_attention_cuda.launches = A.wide_attention_bwd_cuda.launches = 0
    A.wide_attention_resident_cuda.launches = A.wide_attention_bwd_resident_cuda.launches = 0
    A.qkv_attention_f32_cuda.launches = A.qkv_attention_bwd_f32_cuda.launches = 0
    A.flash_attention_f32_cuda.launches = A.flash_attention_bwd_f32_cuda.launches = 0
    G.group_norm_fwd_cuda.launches = G.group_norm_bwd_cuda.launches = 0
    G.group_norm_fwd_legacy_cuda.launches = G.group_norm_bwd_legacy_cuda.launches = 0
    I8.int8_attention_cuda.launches = 0
    CW.conv_wgrad_cuda.launches = CW.conv_wgrad_sm90_cuda.launches = 0
    AP.matmul_probe_cuda.launches = 0
    AP.transposed_attention_cuda.launches = AP.hybrid_attention_cuda.launches = 0
    SP.softmax_stats_cuda.launches = SP.transpose_accumulate_cuda.launches = 0
    AV.attention_variant_cuda.launches = 0


def counts():
    return {"attn_fwd": A.qkv_attention_cuda.launches,
            "attn_bwd": A.qkv_attention_bwd_cuda.launches,
            "flash_fwd": A.flash_attention_cuda.launches,
            "flash_bwd": A.flash_attention_bwd_cuda.launches,
            "attn_fwd_mma": A.qkv_attention_mma_cuda.launches,
            "flash_fwd_mma": A.flash_attention_mma_cuda.launches,
            "attn_bwd_mma": A.qkv_attention_bwd_mma_cuda.launches,
            "flash_bwd_mma": A.flash_attention_bwd_mma_cuda.launches,
            "wide_fwd": A.wide_attention_cuda.launches,
            "wide_bwd": A.wide_attention_bwd_cuda.launches,
            "wide_fwd_resident": A.wide_attention_resident_cuda.launches,
            "wide_bwd_resident": A.wide_attention_bwd_resident_cuda.launches,
            "attn_fwd_f32": A.qkv_attention_f32_cuda.launches,
            "attn_bwd_f32": A.qkv_attention_bwd_f32_cuda.launches,
            "flash_fwd_f32": A.flash_attention_f32_cuda.launches,
            "flash_bwd_f32": A.flash_attention_bwd_f32_cuda.launches,
            "gn_fwd": G.group_norm_fwd_cuda.launches, "gn_bwd": G.group_norm_bwd_cuda.launches,
            "gn_fwd_legacy": G.group_norm_fwd_legacy_cuda.launches,
            "gn_bwd_legacy": G.group_norm_bwd_legacy_cuda.launches,
            "int8": I8.int8_attention_cuda.launches, "wgrad": CW.conv_wgrad_cuda.launches,
            "wgrad_sm90": CW.conv_wgrad_sm90_cuda.launches,
            "mm_probe": AP.matmul_probe_cuda.launches,
            "attn_t": AP.transposed_attention_cuda.launches,
            "hybrid": AP.hybrid_attention_cuda.launches,
            "stats": SP.softmax_stats_cuda.launches,
            "transpose": SP.transpose_accumulate_cuda.launches,
            "variant": AV.attention_variant_cuda.launches}


@functools.lru_cache(maxsize=None)
def wgrad_routes(cfg, size, batch, sites=WGRAD_SITES):
    """How many stride-1 3x3 convs of ``cfg``'s UNet at ``size`` px and
    ``batch`` ``CW.wgrad_route`` gives each body: {"sm90": n, "mma": n}
    (``sites``: the number of convs there must be, None for any)."""
    routes = [CW.wgrad_route(*shape, cfg.dtype)
              for _, *shape in prototype_wgrad_kernel.site_shapes(size, batch, cfg)]
    assert sites is None or len(routes) == sites, len(routes)
    return {k: routes.count(k) for k in ("sm90", "mma")}


def expected(size, forwards, backwards=0, cfg=None, batch=None):
    """The launch counts of ``forwards`` UNet forwards and ``backwards``
    backwards at ``size`` px (a backward: of ``cfg``'s UNet at ``batch``,
    whose routed 3x3 convs launch a weight-gradient kernel each)."""
    qkv, flash = ROUTES[size]
    wg = wgrad_routes(cfg, size, batch) if backwards else {"sm90": 0, "mma": 0}
    return {**{k: 0 for k in counts()},
            "attn_fwd": qkv * forwards, "attn_bwd": qkv * backwards,
            "flash_fwd": flash * forwards, "flash_bwd": flash * backwards,
            "gn_fwd": GN_PER_FORWARD * forwards, "gn_bwd": GN_PER_FORWARD * backwards,
            "wgrad": wg["mma"] * backwards, "wgrad_sm90": wg["sm90"] * backwards}


def dit_expected(forwards, backwards=0):
    """The launch counts of ``forwards`` DiT forwards and ``backwards``
    backwards: the fused-qkv kernel (with the lse in training) and its
    backward once a block each, nothing else."""
    return {**{k: 0 for k in counts()}, "attn_fwd": DIT_DEPTH * forwards,
            "attn_bwd": DIT_DEPTH * backwards}


def unet_train_expected(cfg, size, batch, steps):
    """The launch counts of ``steps`` training steps of ``cfg``'s UNet at
    ``size`` px and ``batch``: a forward and a backward each step
    (:func:`few_expected`)."""
    return few_expected(dataclasses.replace(cfg, image_size=size), batch, steps, steps)


def gn_bound_ms(direction, act, n, hw, c, groups, esize):
    """The card's least time: each input read once and each output written
    once (x and y, or x, dy and dx; gamma, beta [N, C] and mean, rstd [N, G]
    f32; dgamma, dbeta [N, C] f32), or the f32 operations at 67 TFLOP/s."""
    elems = n * hw * c
    if direction == "fwd":
        nbytes = 2 * elems * esize + 4 * (2 * n * c + 2 * n * groups)
    else:
        nbytes = 3 * elems * esize + 4 * (4 * n * c + 2 * n * groups)
    flops = GN_OPS[(direction, act)] * elems
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def gn_stats_errors(x, groups, mean, rstd, drop=None):
    """The statistics against float64: (the largest |mean - mean64| in units
    of the group's std, the largest |rstd - rstd64| / rstd64). ``drop`` =
    (r0, r1) computes them instead for float64 statistics with rows [r0, r1)
    of every sample left out, as a combine that lost one chunk would."""
    n, hw, c = x.shape
    xg = x.double().reshape(n, hw, groups, c // groups)
    var64, mean64 = torch.var_mean(xg, dim=(1, 3), unbiased=False)
    if drop is not None:
        keep = torch.cat([xg[:, :drop[0]], xg[:, drop[1]:]], dim=1)
        var, mean = torch.var_mean(keep, dim=(1, 3), unbiased=False)
        rstd = torch.rsqrt(var + 1e-5)
        del keep
    rstd64 = torch.rsqrt(var64 + 1e-5)
    mean_err = ((mean.double() - mean64).abs() / var64.sqrt()).max().item()
    rstd_err = ((rstd.double() - rstd64).abs() / rstd64).max().item()
    del xg
    return mean_err, rstd_err


def gn_case(n, hw, c, groups, act, dtype, gen, film=False, loc=0.0, fault=False,
            library_silu=False):
    """GroupNorm kernels (forward, then backward from the kernel's mean and
    rstd) vs their plain versions on one shape, with timings, the old body
    (group_norm.cu) timed on the same tensors; the statistics against
    float64, and with ``fault`` a planted lost chunk asserted caught by the
    same check. ``library_silu``: also time ``F.silu(F.group_norm(...))``
    and its backward (``library_silu_ms``), the library's whole function at
    a SiLU site. Returns the forward and backward result rows."""
    x = (loc + torch.randn(n, hw, c, generator=gen, device="cuda")).to(dtype)
    dy = torch.randn(n, hw, c, generator=gen, device="cuda").to(dtype)
    w = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    if film:  # per-sample FiLM folded into gamma and beta, from a bf16 projection
        s = (0.2 * torch.randn(n, c, generator=gen, device="cuda")).to(dtype).float()
        t = (0.2 * torch.randn(n, c, generator=gen, device="cuda")).to(dtype).float()
        gamma, beta = w * (1 + s), b * (1 + s) + t
    else:
        gamma, beta = w.expand(n, c).contiguous(), b.expand(n, c).contiguous()
    y, mean, rstd = G.group_norm_fwd_cuda(x, gamma, beta, groups, 1e-5, act)
    dx, dgamma, dbeta = G.group_norm_bwd_cuda(x, gamma, beta, mean, rstd, dy, groups, act)
    ref = G.group_norm_reference(x, gamma, beta, groups, act=act)
    rdx, rdgamma, rdbeta = G.group_norm_backward_reference(x, gamma, beta, mean, rstd, dy,
                                                           groups, act)
    torch.cuda.synchronize()
    plans = {d: G._card_plan(d, x, n, hw, c, groups)[0] for d in ("fwd", "bwd")}
    label = f"N{n} HW{hw} C{c} G{groups} {act}{' film' if film else ''}{' mean100' if loc else ''}"
    # the statistics against float64, the sum-of-squares recipe of the TPU
    # kernel (E[x^2] - E[x]^2 in f32) beside them, and a lost chunk
    stats_err = gn_stats_errors(x, groups, mean, rstd)
    var64 = x.double().reshape(n, hw, groups, c // groups).var(dim=(1, 3), unbiased=False)
    var_err = ((1 / rstd.double() ** 2 - 1e-5 - var64).abs() / var64).max().item()
    xf = x.float().reshape(n, hw, groups, c // groups)
    naive = xf.pow(2).mean(dim=(1, 3)) - xf.mean(dim=(1, 3)).pow(2)
    naive_var_err = ((naive.double() - var64).abs() / var64).max().item()
    del xf, naive, var64
    assert max(stats_err) <= TOL_GN_STATS and var_err <= 1e-4, (
        f"group norm statistics vs float64 at {label} {dtype}: {stats_err} > {TOL_GN_STATS} "
        f"(variance rel err {var_err})")
    fault_err = None
    if fault:  # the forward's plan: its middle chunk of rows left out
        p = plans["fwd"]
        r0 = p.blocks // 2 * p.chunk_rows
        fault_err = gn_stats_errors(x, groups, mean, rstd, (r0, min(r0 + p.chunk_rows, hw)))
        assert max(fault_err) > TOL_GN_STATS, (
            f"a lost chunk at {label} reads {fault_err}, inside {TOL_GN_STATS}")

    def scaled(got, want, floor):
        diff = (got.float() - want.float()).abs()
        return diff.max().item(), (diff / want.float().abs().clamp(min=floor)).max().item()

    err, sc = scaled(y, ref, 1.0)
    assert math.isfinite(err) and sc <= TOL_GN[dtype], (
        f"group norm forward vs plain at {label} {dtype}: {sc} > {TOL_GN[dtype]}")
    dx_err, dx_sc = scaled(dx, rdx, rdx.float().pow(2).mean().sqrt().item())
    p_sc = max(scaled(got, want, want.pow(2).mean().sqrt().item())[1]
               for got, want in ((dgamma, rdgamma), (dbeta, rdbeta)))
    assert math.isfinite(dx_err) and dx_sc <= TOL_GN[dtype] and p_sc <= TOL_GN_PARAMS, (
        f"group norm backward vs plain at {label} {dtype}: dx {dx_sc}, params {p_sc}")
    # the same bits on a repeat (no atomics in the results)
    y2, mean2, rstd2 = G.group_norm_fwd_cuda(x, gamma, beta, groups, 1e-5, act)
    dx2, dgamma2, dbeta2 = G.group_norm_bwd_cuda(x, gamma, beta, mean, rstd, dy, groups, act)
    same_bits = all(torch.equal(u, v) for u, v in ((y, y2), (mean, mean2), (rstd, rstd2),
                                                    (dx, dx2), (dgamma, dgamma2),
                                                    (dbeta, dbeta2)))
    assert same_bits, f"group norm at {label} {dtype}: a repeat gave other bits"
    del ref, rdx, y2, dx2

    big = n * hw * c >= 2**24
    reps, preps = (20, 3) if big else (100, 20)
    fwd_ms = cuda_ms(lambda: G.group_norm_fwd_cuda(x, gamma, beta, groups, 1e-5, act), reps)
    bwd_ms = cuda_ms(lambda: G.group_norm_bwd_cuda(x, gamma, beta, mean, rstd, dy, groups,
                                                   act), reps)
    old_fwd = cuda_ms(lambda: G.group_norm_fwd_legacy_cuda(x, gamma, beta, groups, 1e-5, act),
                      reps)
    old_bwd = cuda_ms(lambda: G.group_norm_bwd_legacy_cuda(x, gamma, beta, mean, rstd, dy,
                                                           groups, act), reps)
    fwd_plain = cuda_ms(lambda: G.group_norm_reference(x, gamma, beta, groups, act=act), preps,
                        warmup=1)
    bwd_plain = cuda_ms(lambda: G.group_norm_backward_reference(x, gamma, beta, mean, rstd, dy,
                                                                groups, act), preps, warmup=1)
    # the library's yardstick: F.group_norm (affine [C], no SiLU) on an
    # NCHW-contiguous copy of the same data, and its backward alone
    xl = x.permute(0, 2, 1).contiguous().requires_grad_()
    wl, bl = (v.to(dtype).requires_grad_() for v in (w, b))  # it takes x's dtype
    yl = F.group_norm(xl, groups, wl, bl, 1e-5)
    dyl = dy.permute(0, 2, 1).contiguous()
    lib_fwd = cuda_ms(lambda: F.group_norm(xl.detach(), groups, wl.detach(), bl.detach(),
                                           1e-5), reps)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(yl, (xl, wl, bl), dyl, retain_graph=True),
                      reps)
    lib_silu = (None, None)
    if library_silu:
        del yl
        yl = F.silu(F.group_norm(xl, groups, wl, bl, 1e-5))
        lib_silu = (cuda_ms(lambda: F.silu(F.group_norm(xl.detach(), groups, wl.detach(),
                                                        bl.detach(), 1e-5)), reps),
                    cuda_ms(lambda: torch.autograd.grad(yl, (xl, wl, bl), dyl,
                                                        retain_graph=True), reps))
    del xl, yl, dyl
    esize = x.element_size()
    rows = []
    for direction, kms, oms, pms, lms, lsm, e, s in (
            ("fwd", fwd_ms, old_fwd, fwd_plain, lib_fwd, lib_silu[0], err, sc),
            ("bwd", bwd_ms, old_bwd, bwd_plain, lib_bwd, lib_silu[1], dx_err, dx_sc)):
        bound, by = gn_bound_ms(direction, act, n, hw, c, groups, esize)
        p = plans[direction]
        row = {"shape": label, "dtype": str(dtype).split(".")[-1], "max_abs_err": e,
               "max_scaled_err": s, "kernel_ms": kms, "old_body_ms": oms, "plain_ms": pms,
               "library_ms": lms, "bound_ms": bound, "bound_by": by,
               "plan": {"mode": p.mode, "teams": p.teams, "blocks": p.blocks,
                        "chunk_rows": p.chunk_rows, "held_rows": p.held_rows,
                        "threads": p.threads, "smem_bytes": p.smem_bytes}}
        if lsm is not None:
            row["library_silu_ms"] = lsm
        if direction == "fwd":
            row.update(mean_err_std_units=stats_err[0], rstd_rel_err=stats_err[1],
                       var_rel_err=var_err, naive_var_rel_err=naive_var_err,
                       same_bits=same_bits)
            if fault_err is not None:
                row["lost_chunk_reading"] = {"mean_err_std_units": fault_err[0],
                                             "rstd_rel_err": fault_err[1]}
        else:
            row["params_max_scaled_err"] = p_sc
        print(f"group_norm_{direction} " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def int8_case(b, heads, t, d, dtype, gen):
    """The int8 attention kernel vs its plain version on ``[B*H, T, D]``, with
    the bf16 flash kernel and SDPA timed on the same inputs; returns a result
    row."""
    bh = b * heads
    q, k, v = (torch.randn(bh, t, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
    out = I8.int8_attention_cuda(q, k, v)
    plain, l, s_v = I8.int8_attention_reference(q, k, v, return_stats=True)
    torch.cuda.synchronize()
    diff = (out.float() - plain.float()).abs()
    err = diff.max().item()
    over = int((diff > I8.tolerance(plain, l, s_v)).sum().item())
    # elements past the output's rounding: a step of round(p * 127) moved them
    stepped = int((diff > 2.0 ** -7 * plain.float().abs() + 1e-7).sum().item())
    label = f"B{b} H{heads} T{t} D{d}"
    assert math.isfinite(err) and over == 0, (
        f"int8 attention kernel vs plain at {label} {dtype}: {over} elements past the bound")
    del out, plain, diff

    kernel_ms = cuda_ms(lambda: I8.int8_attention_cuda(q, k, v), 50)
    plain_ms = cuda_ms(lambda: I8.int8_attention_reference(q, k, v), 5, warmup=1)
    views = lambda x: x.reshape(b, heads, t, d).permute(0, 2, 1, 3)  # [B, T, H, D]
    flash_ms = cuda_ms(lambda: A.flash_attention_cuda(views(q), views(k), views(v)), 50)
    q4, k4, v4 = (x.reshape(b, heads, t, d) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                scale=1.0 / math.sqrt(d)), 50)
    ops = 4.0 * bh * t * t * d
    nbytes = 4 * bh * t * d * q.element_size()  # q, k, v read, o written
    by_ops, by_bytes = ops / PEAK_INT8, nbytes / PEAK_BYTES_PER_S
    row = {"shape": label, "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "elements_stepped": stepped, "elements": q.numel(), "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "flash_ms": flash_ms, "library_ms": library_ms,
           "bound_ms": max(by_ops, by_bytes) * 1e3,
           "bound_by": "operations" if by_ops >= by_bytes else "bytes"}
    print("int8_attention " + json.dumps(row), flush=True)
    return row


def wgrad_case(b, h, w, c, co, dtype, gen):
    """The conv weight-gradient kernel vs its plain version on one shape,
    with the plain, cuDNN and bound times (the tool's ``measure``); returns
    a result row."""
    x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(b, h, w, co, generator=gen, device="cuda").to(dtype)
    row = prototype_wgrad_kernel.measure(x, dy, reps=10 if b * h * w >= 2**16 else 50)
    assert math.isfinite(row["max_rel_err"]) and row["max_rel_err"] <= TOL_WGRAD[dtype], (
        f"conv_wgrad vs plain at {row['shape']} {dtype}: {row['max_rel_err']} > "
        f"{TOL_WGRAD[dtype]}")
    if "sm90_ms" in row:  # the wgmma body takes the shape
        err = row["sm90_max_rel_err"]
        assert math.isfinite(err) and err <= TOL_WGRAD[dtype], (
            f"conv_wgrad_sm90 vs plain at {row['shape']}: {err} > {TOL_WGRAD[dtype]}")
        first = CW.conv_wgrad_sm90_cuda(x, dy)
        assert torch.equal(CW.conv_wgrad_sm90_cuda(x, dy), first), "sm90: other bits on repeat"
    print("conv_wgrad " + json.dumps(row), flush=True)
    return row


def transposed_case(b, t, heads, d, dtype, gen):
    """The transposed-output attention kernel vs its plain version on one
    shape (plain a sample at a time), with the plain, SDPA and bound times
    (the tool's ``measure``); returns a result row."""
    qkv5 = torch.randn(b, 3, heads, t, d, generator=gen, device="cuda")
    qkv5[:, :2] *= 2.0  # sharper softmax than unit inputs
    row = probe_packed_pv.measure(qkv5.to(dtype), reps=20 if t >= 1024 else 50)
    check_attention(row, dtype, f"transposed attention at {row['shape']}")
    print("attention_fwd_transposed " + json.dumps(row), flush=True)
    return row


def phase_8b(gen, card):
    """Phase 8b: the conv weight-gradient kernel and the transposed-output
    attention against their plain versions, then the three tools once each
    with the launch counters set to 0 before and read after; returns the
    kernel-vs-plain rows and the tools' results."""
    wgrad_rows = [wgrad_case(8, 256, 256, 128, 128, torch.bfloat16, gen),  # the JAX tool's
                  wgrad_case(8, 256, 256, 6, 128, torch.bfloat16, gen),    # the input conv
                  wgrad_case(8, 256, 256, 128, 3, torch.bfloat16, gen),    # the output conv
                  wgrad_case(3, 20, 27, 40, 24, torch.bfloat16, gen),      # ragged tiles
                  wgrad_case(2, 20, 24, 16, 24, torch.float32, gen)]       # f32, TF32 off
    # the wgmma body's five shapes: the tool's and the ragged one above, and
    # a site of each of levels 0-2 of the 256 px step (WGRAD_SM90_CASES)
    wgrad_rows += [wgrad_case(*shape, torch.bfloat16, gen) for shape in WGRAD_SM90_CASES[1:4]]
    deltas = [prototype_wgrad_kernel.delta_check(*shape, gen) for shape in WGRAD_DELTA_CASES]
    print("conv_wgrad_sm90 delta " + json.dumps(deltas), flush=True)
    assert all(d["exact"] and d["deltas"] >= 9 for d in deltas), deltas
    attn_t_rows = [transposed_case(8, 4096, 8, 48, torch.bfloat16, gen),  # the probe's shape
                   transposed_case(2, 1000, 3, 40, torch.float32, gen)]   # ragged f32
    torch.cuda.empty_cache()
    tools = {}
    for name, tool, kw in (("wgrad", prototype_wgrad_kernel, {"sites": "unet256"}),
                           ("mm_probe", probe_attn_matmuls, {}),
                           ("attn_t", probe_packed_pv, {})):
        reset_counts()
        res = tool.run(**kw)
        launched = counts()
        assert launched[name] > 0, (name, launched)
        res["launches"] = launched[name]
        if name == "wgrad":
            res["launches_sm90"] = launched["wgrad_sm90"]
        tools[name] = res
        torch.cuda.empty_cache()
    sweep = tools["wgrad"]
    print("conv_wgrad_sweep " + json.dumps(sweep), flush=True)
    assert sweep["sites"] == WGRAD_SITES, sweep["sites"]
    assert sweep["max_cudnn_rel_err"] <= TOL_WGRAD_CUDNN, sweep["max_cudnn_rel_err"]
    assert sweep["max_rel_err"] <= TOL_WGRAD[torch.bfloat16], sweep["max_rel_err"]
    assert sweep["max_sm90_rel_err"] <= TOL_WGRAD[torch.bfloat16], sweep["max_sm90_rel_err"]
    assert sweep["max_sm90_cudnn_rel_err"] <= TOL_WGRAD_CUDNN, sweep["max_sm90_cudnn_rel_err"]
    assert sweep["launches_sm90"] > 0 and sweep["sites_sm90_takes"] == WGRAD_SITES - 2
    print("conv_wgrad over the 49 stride-1 3x3 sites of a sen12mscr256 step, b8: "
          + json.dumps(sweep["sums"]) + f"; {card}", flush=True)
    mm = tools["mm_probe"]
    print("probe_attn_matmuls " + json.dumps(mm), flush=True)
    assert all(v["max_rel_err"] <= TOL_PROBE for v in mm["variants"]), \
        [v["max_rel_err"] for v in mm["variants"]]
    packed = tools["attn_t"]
    print("probe_packed_pv " + json.dumps(packed), flush=True)
    check_attention(packed, torch.bfloat16, "probe_packed_pv")
    return wgrad_rows, deltas, attn_t_rows, sweep, mm, packed


def check_attention(row, dtype, what):
    """An attention probe's row against TOL and TOL_ATTN_L2."""
    err, l2 = row["max_rms_scaled_err"], row["rel_l2_err"]
    assert math.isfinite(err) and err <= TOL[dtype] and l2 <= TOL_ATTN_L2[dtype], (
        f"{what} vs plain: {err} > {TOL[dtype]} of max(rms, |plain|) or rel L2 {l2} > "
        f"{TOL_ATTN_L2[dtype]}")


def check_faults_caught(row, what, tol=TOL[torch.bfloat16],
                        tol_l2=TOL_ATTN_L2[torch.bfloat16]):
    """The planted faults of an attention row each break a limit (the
    probes' by default)."""
    for name, f in row["planted_faults"].items():
        assert f["max_rms_scaled_err"] > tol or f["rel_l2_err"] > tol_l2, (what, name, f)


def check_softmax_probes(res, where):
    """The tolerances of ``probe_softmax_orient.measure``'s rows."""
    for name in ("stats_rows", "stats_cols"):
        err = res[name]["max_rel_err"]
        assert math.isfinite(err) and err <= TOL_STATS, f"{name} at {where}: {err} > {TOL_STATS}"
    assert res["transpose"]["bit_exact"], f"transpose at {where}: {res['transpose']}"
    for name, row in res.items():
        if name.startswith("hybrid"):
            check_attention(row, torch.bfloat16, f"{name} at {where}")


def check_variants(res, where):
    """The tolerances of ``profile_attn_variants.measure``'s rows."""
    for row in res["rows"]:
        what = f"variant {row['variant']} at {row['warps']} warps, {row['block_k']} keys, {where}"
        check_attention(row, torch.bfloat16, what)
        if "planted_faults" in row:
            check_faults_caught(row, what)


def phase_8c(gen):
    """Phase 8c: the softmax-orientation probes (2c: statistics, transpose,
    hybrid attentions) and the attention variants (2d: A-D, the tile sweep,
    the fused-layout route through K1) against their plain versions at a
    ragged small shape (T 1000, D 40, cells that fit no tile) through the
    tools' ``measure``, then the four tools once each at their shape (B8
    T4096 H8 D48) with the launch counters set to 0 before and read after;
    returns the small-shape results and the tools' results."""
    bf16 = torch.bfloat16
    s = 3.0 * torch.randn(3, 37, 100, generator=gen, device="cuda")
    p = torch.randn(3, 37, 100, generator=gen, device="cuda").to(bf16)
    qkv5 = torch.randn(2, 3, 3, 1000, 40, generator=gen, device="cuda")
    qkv5[:, :2] *= 2.0  # sharper softmax than unit inputs
    small = {"softmax": probe_softmax_orient.measure(s, p, qkv5.to(bf16), reps=10,
                                                     block_ks=(64, 128))}
    check_softmax_probes(small["softmax"], "the ragged shape")
    q, k, v = (torch.randn(2, 1000, 3, 40, generator=gen, device="cuda").to(bf16)
               for _ in range(3))
    small["variants"] = profile_attn_variants.measure(q, k, v, reps=10)
    small["sweep"] = profile_attn_variants2.measure(q, k, v, tiles=((16, 64), (16, 128)), reps=10)
    for name in ("variants", "sweep"):
        check_variants(small[name], "the ragged shape")
    qkv = torch.randn(2, 1000, 3, 3, 40, generator=gen, device="cuda")
    qkv[:, :, :2] *= 2.0
    small["fused"] = profile_attn_fusedlayout.measure(qkv.to(bf16), reps=10)
    check_attention(small["fused"], bf16, "the fused-layout route at the ragged shape")
    check_faults_caught(small["fused"], "the fused-layout route at the ragged shape")
    print("probes_2c_2d_ragged " + json.dumps(small), flush=True)
    del s, p, qkv5, q, k, v, qkv
    torch.cuda.empty_cache()

    tools = {}
    for name, tool, kw, counters in (
            ("softmax", probe_softmax_orient, {"extra": True}, ("stats", "transpose", "hybrid")),
            ("variants", profile_attn_variants, {}, ("variant", "flash_fwd_mma")),
            ("sweep", profile_attn_variants2, {}, ("variant",)),
            ("fused", profile_attn_fusedlayout, {}, ("attn_fwd",))):
        reset_counts()
        res = tool.run(**kw)
        launched = counts()
        assert all(launched[c] > 0 for c in counters), (name, launched)
        res["launches"] = {c: launched[c] for c in counters}
        tools[name] = res
        print(f"{tool.__name__.rsplit('.', 1)[-1]} " + json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    check_softmax_probes(tools["softmax"], "the probe's shape")
    for name in ("variants", "sweep"):
        check_variants(tools[name], "B8 T4096 H8 D48")
    check_attention(tools["fused"], bf16, "the fused-layout route at B8 T4096 H8 D48")
    check_faults_caught(tools["fused"], "the fused-layout route at B8 T4096 H8 D48")
    return small, tools


def dit_forward_check(cfg, batch, gen, label):
    """One DiT forward: the kernels against the all-plain model (plain
    attention), same weights; one fused-qkv launch a block."""
    model = randomize_parameters(DiT(cfg), seed=1).cuda().eval()
    x = torch.randn(batch, cfg.image_size, cfg.image_size, cfg.in_channels, generator=gen,
                    device="cuda")
    ts = torch.linspace(999.0, 1.0, batch, device="cuda")
    with torch.inference_mode():
        reset_counts()
        out_k = model(x, ts).float()
        launched = counts()
        out_p = model.set_impl("plain")(x, ts).float()
        assert counts() == launched, counts()
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    print(f"{label} forward b{batch}: rel L2 kernels vs plain {rel:.3e} (tol {TOL_UNET_REL}), "
          f"max abs {(out_k - out_p).abs().max().item():.3e}, |out| rms "
          f"{out_p.pow(2).mean().sqrt().item():.3e}, launches {launched}", flush=True)
    assert torch.isfinite(out_k).all() and rel <= TOL_UNET_REL, rel
    assert launched == dit_expected(1), launched
    return rel


def unet_forward_check(size, batch, gen):
    """One clouds-UNet forward at ``size`` px: the kernels against the
    all-plain model (plain attention and plain norms), same weights; returns
    the model."""
    cfg = unet_clouds(size, dtype=torch.bfloat16)
    model = randomize_parameters(UNet(cfg), seed=1).cuda().eval()
    x = torch.randn(batch, size, size, 3, generator=gen, device="cuda")
    ts = torch.tensor([10, 500][:batch], device="cuda")
    with torch.inference_mode():
        reset_counts()
        out_k = model(x, ts).float()
        fwd_launches = counts()
        out_p = model.set_impl(attn="plain", norm="plain")(x, ts).float()
        assert not any(counts()[k] - fwd_launches[k] for k in fwd_launches), counts()
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    print(f"unet{size} forward: rel L2 kernels vs plain {rel:.3e} (tol {TOL_UNET_REL}), "
          f"max abs {(out_k - out_p).abs().max().item():.3e}, |out| rms "
          f"{out_p.pow(2).mean().sqrt().item():.3e}, launches {fwd_launches}", flush=True)
    assert torch.isfinite(out_k).all() and rel <= TOL_UNET_REL, rel
    assert fwd_launches == expected(size, 1), fwd_launches
    return model


def unet_backward_check(model, size, batch, gen):
    """One loss and backward of the UNet with the kernels against the
    plain attention and norms: same weights, same batch, same timesteps and
    noise."""
    diffusion = GaussianDiffusion.create(timesteps=1000, image_size=size)
    x0 = torch.randn(batch, size, size, 3, generator=gen, device="cuda")
    noise = torch.randn(batch, size, size, 3, generator=gen, device="cuda")
    ts = torch.tensor([10, 500][:batch], device="cuda")
    model_fn = lambda x, t, c, y: model(x, t)
    grads, losses, launched = {}, {}, None
    for impl in ("auto", "plain"):
        model.set_impl(attn=impl, norm=impl, conv=impl).zero_grad(set_to_none=True)
        reset_counts()
        loss = diffusion.train_loss(model_fn, x0, t=ts, noise=noise)
        loss.backward()
        torch.cuda.synchronize()
        if impl == "auto":
            launched = counts()
        else:
            assert not any(counts().values()), counts()
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    num = den = 0.0
    for name, gk in grads["auto"].items():
        gp = grads["plain"][name]
        assert torch.isfinite(gk).all(), f"non-finite gradient of {name}"
        if name.endswith("qkv.weight"):
            assert gk.abs().max().item() > 0, f"{name} got no gradient"
        num += (gk - gp).pow(2).sum().item()
        den += gp.pow(2).sum().item()
    rel = math.sqrt(num / den)
    print(f"unet{size} loss+backward: loss {losses['auto']:.6f} (plain "
          f"{losses['plain']:.6f}), {len(grads['auto'])} parameter gradients finite, rel L2 "
          f"kernel vs plain {rel:.3e} (tol {TOL_UNET_GRAD_REL}), launches {launched}",
          flush=True)
    assert rel <= TOL_UNET_GRAD_REL, rel
    assert launched == expected(size, 1, 1, model.config, batch), launched


def run_train(tmp, seed):
    """The training entry point at sen12mscr256 width and depth, then a
    restore of its checkpoint and a short sampling run from it."""
    argv = ["--preset", "sen12mscr256", "--dataset", "synthetic", "--batch_size", "8",
            "--epochs", "1", "--steps_per_epoch", str(TRAIN_STEPS), "--sample_every", "0",
            "--save_every", "0", "--model_ema_steps", "2", "--log_freq", "1",
            "--seed", str(seed), "--device", "cuda", "--dir", "results/train_smoke"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with contextlib.chdir(tmp):  # the CLI writes logs/ and results/ under the cwd
        res = cli_train.main(cli_train.parse_args(argv))
    res["launches"] = counts()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    assert res["steps"] == TRAIN_STEPS and len(res["losses"]) == TRAIN_STEPS, res["steps"]
    assert all(math.isfinite(x) for x in res["losses"]), res["losses"]
    cfg = get_preset("sen12mscr256").unet_config(cond_channels=3)
    want = expected(256, TRAIN_STEPS, TRAIN_STEPS, cfg, 8)
    assert res["launches"] == want and want["wgrad_sm90"] > 0, (res["launches"], want)

    # parameters and EMA moved away from the seeded initial weights
    state = res["state"]
    torch.manual_seed(seed)
    init = UNet(state.model.config).to("cuda")
    moved = lambda m: math.sqrt(sum((p.detach() - q.detach()).pow(2).sum().item()
                                    for p, q in zip(m.parameters(), init.parameters())))
    res["param_delta"], res["ema_delta"] = moved(state.model), moved(state.ema_model)
    assert res["param_delta"] > 0 and res["ema_delta"] > 0, (res["param_delta"], res["ema_delta"])

    # the checkpoint restores, and the sampling entry point reads it (EMA first)
    ckpt = res["checkpoint"]
    raw = restore_checkpoint(ckpt)
    assert raw["step"] == TRAIN_STEPS and set(raw) >= {"model", "model_ema", "opt_state"}
    for name, v in state.ema_model.state_dict().items():
        assert torch.equal(raw["model_ema"][name], v.cpu()), name
    args = cli.parse_args(["--preset", "sen12mscr256", "--dataset", "synthetic", "--sampler",
                           "ddim", "--sampler_steps", "4", "--batch_size", "2", "--n_iter", "0",
                           "--device", "cuda", "--ckpt", ckpt, "--seed", str(seed),
                           "--outdir", os.path.join(tmp, "out_train")])
    reset_counts()
    sampled = cli.main(args)
    x = torch.as_tensor(sampled["samples"])
    assert x.shape == (2, 256, 256, 3) and bool(torch.isfinite(x).all()), x.shape
    assert counts() == expected(256, 4), counts()
    del res["state"]
    return res


def run_train_512(tmp, seed):
    """The training entry point at --image_size 512, batch 4: ds 4 attends
    over T 16384 through the separate-tensor entries both ways."""
    argv = ["--preset", "sen12mscr256", "--image_size", "512", "--dataset", "synthetic",
            "--batch_size", "4", "--epochs", "1", "--steps_per_epoch", str(TRAIN_STEPS_512),
            "--sample_every", "0", "--save_every", "0", "--model_ema_steps", "2",
            "--log_freq", "1", "--seed", str(seed), "--device", "cuda",
            "--dir", "results/train_smoke_512"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with contextlib.chdir(tmp):
        res = cli_train.main(cli_train.parse_args(argv))
    res["launches"] = counts()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    assert res["steps"] == TRAIN_STEPS_512, res["steps"]
    assert all(math.isfinite(x) for x in res["losses"]), res["losses"]
    cfg = get_preset("sen12mscr256").unet_config(cond_channels=3)
    want = expected(512, TRAIN_STEPS_512, TRAIN_STEPS_512, cfg, 4)
    assert res["launches"] == want and want["wgrad_sm90"] > 0, (res["launches"], want)
    del res["state"]
    return res


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def grads_rel_l2(got, want):
    """Relative L2 difference of two {name: gradient} sets, all together."""
    num = sum((g - want[n]).pow(2).sum().item() for n, g in got.items())
    return math.sqrt(num / sum(w.pow(2).sum().item() for w in want.values()))


def dit_train_check(model, process, x0, gen, label, cond=None, want=None, set_impl=None):
    """One flow-matching loss and backward of the DiT ``model`` through
    ``process`` (FlowMatching, or LatentDiffusion over it) on ``x0`` with the
    kernels against the all-plain model (``DiT.set_impl("plain")``, and
    ``set_impl("plain")`` for the rest of the path): same weights, batch,
    times and noise. The forward's velocity and the gradients by their
    relative L2 difference (phase 4's limits); every parameter gets a finite
    gradient, the qkv weights a non-zero one; the launches are ``want``
    (default K1 with the lse and K4 once a block, nothing else)."""
    batch, s, ch = x0.shape[0], process.image_size, process.in_channels
    noise = torch.randn(batch, s, s, ch, generator=gen, device="cuda")
    t = torch.linspace(0.02, 0.98, batch, device="cuda")
    preds, losses, grads, launched = {}, {}, {}, {}
    for impl in ("auto", "plain"):
        model.set_impl(impl).train().zero_grad(set_to_none=True)
        if set_impl is not None:
            set_impl(impl)

        def model_fn(x, tt, c, y, impl=impl):
            out = model(x, tt, cond=c)
            preds[impl] = out.detach().float()
            return out

        reset_counts()
        loss = process.train_loss(model_fn, x0, cond=cond, t=t, noise=noise)
        loss.backward()
        torch.cuda.synchronize()
        launched[impl] = counts()
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    want = dit_expected(1, 1) if want is None else want
    assert launched["auto"] == want, (launched["auto"], want)
    assert not any(launched["plain"].values()), launched["plain"]
    for name, gk in grads["auto"].items():
        assert torch.isfinite(gk).all(), f"non-finite gradient of {name}"
        if name.endswith("qkv.weight"):
            assert gk.abs().max().item() > 0, f"{name} got no gradient"
    fwd_rel = rel_l2(preds["auto"], preds["plain"])
    grad_rel = grads_rel_l2(grads["auto"], grads["plain"])
    print(f"{label} flow loss+backward b{batch}: loss {losses['auto']:.6f} (plain "
          f"{losses['plain']:.6f}); velocity rel L2 kernels vs plain {fwd_rel:.3e} (tol "
          f"{TOL_UNET_REL}); {len(grads['auto'])} parameter gradients finite, rel L2 "
          f"{grad_rel:.3e} (tol {TOL_UNET_GRAD_REL}); launches {launched['auto']}", flush=True)
    assert fwd_rel <= TOL_UNET_REL and grad_rel <= TOL_UNET_GRAD_REL, (fwd_rel, grad_rel)
    return {"loss": losses["auto"], "loss_plain": losses["plain"], "forward_rel_l2": fwd_rel,
            "grad_rel_l2": grad_rel, "launches": launched["auto"]}


def train_argv(preset, batch, steps, seed, tag):
    return ["--preset", preset, "--dataset", "synthetic", "--batch_size", str(batch),
            "--epochs", "1", "--steps_per_epoch", str(steps), "--sample_every", "0",
            "--save_every", "0", "--model_ema_steps", "2", "--log_freq", "1",
            "--seed", str(seed), "--device", "cuda", "--dir", f"results/{tag}"]


def steady_sps(res):
    """Steps/s of the step alone after the first two (cuBLAS's and cuDNN's
    first calls)."""
    st = res["step_seconds"][2:]
    return len(st) / sum(st)


def run_train_dit(tmp, seed, card):
    """The training entry point with ``dit256`` at full width and depth,
    batch 16: K1 with the lse and K4 twelve times a step each, nothing
    else; its checkpoint restores and the sampling entry point integrates
    the flow from it (Heun-8). Then ``flow64`` and ``dit64`` a few steps
    each, and ``inria64`` (whose middle attention, one head of D 1024, takes
    the wide kernels both ways), with the launches their forwards give."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with contextlib.chdir(tmp):
        res = cli_train.main(cli_train.parse_args(
            train_argv("dit256", DIT_TRAIN_BATCH, TRAIN_STEPS, seed, "train_dit256")))
    res["launches"] = counts()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    assert res["steps"] == TRAIN_STEPS and all(math.isfinite(x) for x in res["losses"]), (
        res["losses"])
    assert res["launches"] == dit_expected(TRAIN_STEPS, TRAIN_STEPS), res["launches"]
    state = res.pop("state")
    torch.manual_seed(seed)
    init = DiT(state.model.config).to("cuda")
    res["param_delta"] = math.sqrt(sum((p.detach() - q.detach()).pow(2).sum().item()
                                       for p, q in zip(state.model.parameters(),
                                                       init.parameters())))
    assert res["param_delta"] > 0, res["param_delta"]
    raw = restore_checkpoint(res["checkpoint"])
    assert raw["step"] == TRAIN_STEPS and set(raw) >= {"model", "model_ema", "opt_state"}
    for name, v in state.ema_model.state_dict().items():
        assert torch.equal(raw["model_ema"][name], v.cpu()), name
    del state, init, raw
    res["sps"] = steady_sps(res)
    print(f"training path dit256 (DiT-B/8, flow) b{DIT_TRAIN_BATCH} bf16: {res['steps']} steps "
          f"in {res['seconds']:.3f} s; steady {res['sps']:.4f} steps/s (step alone) = "
          f"{DIT_TRAIN_BATCH * res['sps']:.4f} img/s; loss {res['losses'][0]:.5f} -> "
          f"{res['losses'][-1]:.5f}; launches {res['launches']}; |d params| "
          f"{res['param_delta']:.4e}; peak memory {res['peak_mem_gb']:.2f} GiB; {card}",
          flush=True)

    args = cli.parse_args(["--preset", "dit256", "--dataset", "synthetic", "--sampler", "flow",
                           "--flow_method", "heun", "--sampler_steps", "8", "--batch_size", "8",
                           "--n_iter", "0", "--device", "cuda", "--ckpt", res["checkpoint"],
                           "--seed", str(seed), "--outdir", os.path.join(tmp, "out_dit")])
    reset_counts()
    x = torch.as_tensor(cli.main(args)["samples"])
    assert x.shape == (8, 256, 256, 3) and bool(torch.isfinite(x).all()), x.shape
    assert counts() == dit_expected(15), counts()
    res["sample_launches"] = counts()

    res["short"] = {}
    for preset in ("flow64", "dit64", "inria64"):
        p = get_preset(preset)
        if p.backbone == "dit":
            want = dit_expected(SHORT_STEPS, SHORT_STEPS)
        else:
            want = unet_train_expected(p.model_config(), p.image_size, DIT_TRAIN_BATCH,
                                       SHORT_STEPS)
        reset_counts()
        with contextlib.chdir(tmp):
            r = cli_train.main(cli_train.parse_args(
                train_argv(preset, DIT_TRAIN_BATCH, SHORT_STEPS, seed, f"train_{preset}")))
        got = counts()
        assert r["steps"] == SHORT_STEPS and all(math.isfinite(x) for x in r["losses"]), r
        assert got == want, (preset, got, want)
        res["short"][preset] = {"losses": r["losses"], "launches": got, "sps": steady_sps(r)}
        print(f"training path {preset} ({p.backbone}, {p.process}) b{DIT_TRAIN_BATCH} bf16: "
              f"{SHORT_STEPS} steps, loss {r['losses'][0]:.5f} -> {r['losses'][-1]:.5f}; "
              f"{res['short'][preset]['sps']:.4f} steps/s over the last {SHORT_STEPS - 2}; "
              f"launches {got}; {card}", flush=True)
        del r
    torch.cuda.empty_cache()
    return res


def latent_expected(dit_forwards=0, dit_backwards=0, norms=0, norms_bwd=0):
    """The launch counts of a latent path: the DiT's fused-qkv kernel and its
    backward once a block, and ``norms`` / ``norms_bwd`` GroupNorm launches
    of the first stage (float32: its convs' weight gradients are cuDNN's)."""
    return {**dit_expected(dit_forwards, dit_backwards), "gn_fwd": norms, "gn_bwd": norms_bwd}


def latent_train_check(gen):
    """Phase 4e: the latent256-cr stack at full width, batch 32. The float32
    first stage (seeded weights): encode -> decode and one reconstruction
    loss and backward, the GroupNorm kernels against the all-plain AE. Then
    one conditional DiT-B/4 flow loss and backward on the encoded x0 and
    cloudy view, the kernels against the all-plain DiT and AE (phase 4d's
    limits), with K1 (lse) and K4 once a block, the first stage forward only
    (6 GroupNorm launches, no backward, no gradient on its weights)."""
    preset = get_preset("latent256-cr")
    ae = randomize_parameters(ConvAutoencoder(preset.ae_config()), seed=7).cuda()
    b, s, ls = LATENT_BATCH, preset.image_size, preset.latent_size
    x0 = torch.rand(b, s, s, 3, generator=gen, device="cuda") * 2 - 1
    cond = torch.rand(b, s, s, 3, generator=gen, device="cuda") * 2 - 1
    outs, losses, grads, launched = {}, {}, {}, {}
    for impl in ("auto", "plain"):
        ae.set_impl(norm=impl, conv=impl).zero_grad(set_to_none=True)
        reset_counts()
        with torch.no_grad():
            outs[impl] = ae(x0)
        loss, _ = AET.ae_loss(ae, x0)
        loss.backward()
        torch.cuda.synchronize()
        launched[impl] = counts()
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad.clone() for n, p in ae.named_parameters()}
        ae.zero_grad(set_to_none=True)
    assert launched["auto"] == latent_expected(norms=2 * AE_NORMS, norms_bwd=AE_NORMS), (
        launched["auto"])
    assert not any(launched["plain"].values()), launched["plain"]
    res = {"ae_out_rel_l2": rel_l2(outs["auto"], outs["plain"]),
           "ae_loss": losses["auto"], "ae_loss_plain": losses["plain"],
           "ae_grad_rel_l2": grads_rel_l2(grads["auto"], grads["plain"]),
           "ae_launches": launched["auto"]}
    del outs, grads
    assert all(torch.isfinite(p).all() for p in ae.parameters())
    print(f"latent256-cr first stage (f32, base 128) b{b}: encode -> decode rel L2 kernels vs "
          f"plain {res['ae_out_rel_l2']:.3e}; loss {res['ae_loss']:.6f} (plain "
          f"{res['ae_loss_plain']:.6f}); gradients rel L2 {res['ae_grad_rel_l2']:.3e} (tol "
          f"{TOL_AE_REL}); launches {res['ae_launches']}", flush=True)
    assert res["ae_out_rel_l2"] <= TOL_AE_REL and res["ae_grad_rel_l2"] <= TOL_AE_REL, res
    assert abs(losses["auto"] - losses["plain"]) <= TOL_AE_REL * abs(losses["plain"]), losses

    ae.set_impl()
    with torch.no_grad():
        scale = 1.0 / ae.encode(x0).float().std(correction=0).item()
    ld = AET.latent_process(FlowMatching.create(image_size=ls, in_channels=4,
                                                cond_type="concat"), ae, scale)
    model = randomize_parameters(DiT(preset.model_config(cond_channels=4)), seed=8).cuda()
    res["scale_factor"] = scale
    res["dit"] = dit_train_check(
        model, ld, x0, gen, f"latent256-cr DiT-B/4 on encoded latents (scale_factor {scale:.5f})",
        cond=cond, want=latent_expected(1, 1, norms=AE_NORMS),
        set_impl=lambda impl: ae.set_impl(norm=impl))
    ae.set_impl()
    assert all(p.grad is None for p in ae.parameters())
    del model, ae
    torch.cuda.empty_cache()
    return res


def run_tiled_flow(seed, gen, n, steps, card):
    """Phase 5e: tiled_flow_sample of n 512 x 512 scenes with the dit256
    denoiser (256 px tiles, 3 x 3 at overlap 0.5, Heun: 2 * steps - 1
    stitched calls over all tiles at once), seeded weights."""
    model = randomize_parameters(DiT(get_preset("dit256").model_config()), seed).cuda().eval()
    flow = FlowMatching.create(image_size=256)
    model_fn = lambda x, t, c, y: model(x, t)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        x = tiled_flow_sample(flow, model_fn, n, 512, 512, device="cuda", generator=gen,
                              num_steps=steps, method="heun").x.float().cpu()
        seconds = time.perf_counter() - t0
    launched = counts()
    calls = 2 * steps - 1
    assert x.shape == (n, 512, 512, 3) and bool(torch.isfinite(x).all()), x.shape
    assert launched == dit_expected(calls), launched
    res = {"seconds": seconds, "images": n, "model_calls": calls, "launches": launched,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    print(f"tiled_flow_sample 512x512 dit256 tile 256 overlap 0.5 Heun-{steps} b{n}: "
          f"{calls} stitched calls over 9 tiles a scene, {n} scenes in {seconds:.3f} s = "
          f"{n / seconds:.4f} img/s; kernel launches {launched}; peak memory "
          f"{res['peak_mem_gb']:.2f} GiB; {card}", flush=True)
    del model
    torch.cuda.empty_cache()
    return res


def run_train_latent(tmp, seed, card):
    """Phase 7f: ``cli.train --preset latent256-cr`` at full width and depth,
    batch 32: the float32 first stage trains LATENT_AE_STEPS steps (6
    GroupNorm launches each way a step, nothing else; 3 more forward for the
    scale factor) and is saved under ``ae/``, then DiT-B/4 trains
    LATENT_DIT_STEPS steps on the encoded grid (K1 with the lse and K4 12 a
    step, the first stage 6 forward, no GroupNorm backward, no weight-
    gradient kernel). The counters are read when the first stage is saved,
    between the two stages. The checkpoint and ``ae/`` restore, and
    ``cli.inference --sampler flow`` (Heun-8) samples a batch of 8 of the
    test split's cloudy views from them and decodes (180 K1 launches and 6
    GroupNorm launches a batch)."""
    argv = train_argv("latent256-cr", LATENT_BATCH, LATENT_DIT_STEPS, seed, "train_latent")
    argv += ["--ae_steps", str(LATENT_AE_STEPS)]
    at_save = {}
    real_save = AET.save_ae

    def save_and_count(*a, **kw):
        torch.cuda.synchronize()
        at_save.update(counts())
        return real_save(*a, **kw)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    AET.save_ae = save_and_count
    try:
        with contextlib.chdir(tmp):
            res = cli_train.main(cli_train.parse_args(argv))
    finally:
        AET.save_ae = real_save
    total = counts()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    ae = res["ae"]
    assert ae["trained"] and ae["steps"] == LATENT_AE_STEPS, ae
    res["ae_launches"] = dict(at_save)
    res["launches"] = {k: v - at_save[k] for k, v in total.items()}
    assert res["ae_launches"] == latent_expected(
        norms=AE_NORMS * LATENT_AE_STEPS + AE_NORMS // 2,
        norms_bwd=AE_NORMS * LATENT_AE_STEPS), res["ae_launches"]
    assert res["launches"] == latent_expected(LATENT_DIT_STEPS, LATENT_DIT_STEPS,
                                              norms=AE_NORMS * LATENT_DIT_STEPS), res["launches"]
    assert res["steps"] == LATENT_DIT_STEPS and all(math.isfinite(x) for x in res["losses"]), (
        res["losses"])
    ae_st = ae["step_seconds"][2:]  # after cuDNN's first calls
    res["ae_ms_per_step"] = 1e3 * sum(ae_st) / len(ae_st)
    res["sps"] = steady_sps(res)
    res["dit_ms_per_step"] = 1e3 / res["sps"]
    state = res.pop("state")
    ae_dir = os.path.join(tmp, ae["dir"])
    ae_model, scale = AET.load_ae(ae_dir)
    torch.manual_seed(seed)
    init = ConvAutoencoder(get_preset("latent256-cr").ae_config())
    res["ae_param_delta"] = math.sqrt(sum((p - q).pow(2).sum().item() for p, q in
                                          zip(ae_model.parameters(), init.parameters())))
    assert scale == ae["scale_factor"] and res["ae_param_delta"] > 0, (scale, res)
    raw = restore_checkpoint(os.path.join(tmp, res["checkpoint"]))
    assert raw["step"] == LATENT_DIT_STEPS and set(raw) >= {"model", "model_ema", "opt_state"}
    for name, v in state.ema_model.state_dict().items():
        assert torch.equal(raw["model_ema"][name], v.cpu()), name
    del state, raw, ae_model, init
    print(f"training path latent256-cr (f32 f4 first stage, base 128; DiT-B/4 flow) "
          f"b{LATENT_BATCH}: first stage {LATENT_AE_STEPS} steps, steady "
          f"{res['ae_ms_per_step']:.3f} ms a step = {1e3 / res['ae_ms_per_step']:.4f} steps/s, "
          f"scale_factor {scale:.5f}, launches {res['ae_launches']}; DiT {res['steps']} steps, "
          f"steady {res['sps']:.4f} steps/s (step alone, {res['dit_ms_per_step']:.3f} ms) = "
          f"{LATENT_BATCH * res['sps']:.4f} img/s, loss {res['losses'][0]:.5f} -> "
          f"{res['losses'][-1]:.5f}, launches {res['launches']}; peak memory "
          f"{res['peak_mem_gb']:.2f} GiB; {card}", flush=True)

    args = cli.parse_args(["--preset", "latent256-cr", "--dataset", "synthetic", "--sampler",
                           "flow", "--flow_method", "heun", "--sampler_steps", "8",
                           "--batch_size", str(LATENT_SAMPLE_BATCH), "--n_iter", "1",
                           "--metrics", "--device", "cuda",
                           "--ckpt", os.path.join(tmp, res["checkpoint"]), "--seed", str(seed),
                           "--outdir", os.path.join(tmp, "out_latent")])
    reset_counts()
    sampled = cli.main(args)
    x = torch.as_tensor(sampled["samples"])
    assert x.shape == (LATENT_SAMPLE_BATCH, 256, 256, 3) and bool(torch.isfinite(x).all())
    want = latent_expected(15 * sampled["batches"], norms=AE_NORMS * sampled["batches"])
    assert counts() == want, (counts(), want)
    res["sample_launches"] = counts()
    res["sample_img_s"] = LATENT_SAMPLE_BATCH / sampled["batch_seconds"][-1]
    res["sample_metrics"] = {k: sampled[k] for k in ("ssim", "psnr")}
    print(f"cli.inference latent256-cr Heun-8 b{LATENT_SAMPLE_BATCH} from phase 7f's "
          f"checkpoint and ae/: "
          f"{sampled['batches']} batches of the test split's cloudy views, batch seconds "
          f"{[round(v, 4) for v in sampled['batch_seconds']]}, {res['sample_img_s']:.4f} img/s "
          f"(the second); launches {res['sample_launches']}; ssim {sampled['ssim']:.4f} psnr "
          f"{sampled['psnr']:.3f} (seeded first stage, {LATENT_DIT_STEPS} DiT steps); {card}",
          flush=True)
    torch.cuda.empty_cache()
    return res


def seeded_inception(seed):
    """InceptionV3 under torchvision's names with seeded weights: He-scaled
    kernels, BatchNorm near the identity with positive variances."""
    from eo_diffusion_torch.models.inception import InceptionV3

    model = InceptionV3()
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = v
            continue
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean"):
            a = 0.1 * rng.normal(size=shape)
        elif k.endswith("bn.weight"):
            a = 1 + 0.05 * rng.normal(size=shape)
        elif len(shape) > 1:
            a = rng.normal(size=shape) * np.sqrt(2 / np.prod(shape[1:]))
        else:
            a = 0.05 * rng.normal(size=shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def phase_7e(tmp, card, sen):
    """Evaluation on the card. ``sen`` is phase 7c's result: its SEN12MS-CR
    tree and checkpoint."""
    from eo_diffusion_torch.data.factories import create_sen12mscr_dataloaders
    from eo_diffusion_torch.models import feature_cnn as FC
    from eo_diffusion_torch.models.inception import inception_feature_extractor, preprocess
    from eo_diffusion_torch.utils import metrics as M
    from eo_diffusion_torch.utils.images import rescale_to_unit, save_image_grid

    # (a) SSIM/PSNR in the sampling CLI, against the CPU on the same samples
    out = os.path.join(tmp, "out_metrics")
    args = cli.parse_args(["--preset", "sen12mscr256", "--dataset", "sen12mscr", "--data_root",
                           sen["root"], "--ckpt", sen["checkpoint"], "--sampler", "ddim",
                           "--sampler_steps", "4", "--batch_size", "8", "--n_iter", "0",
                           "--metrics", "--samples_fid", "--device", "cuda", "--seed", "9",
                           "--outdir", out])
    reset_counts()
    res = cli.main(args)
    assert counts() == expected(256, 4), counts()
    with open(os.path.join(out, "metrics.txt")) as f:
        written = {k: float(v) for k, v in (line.split(": ") for line in f.read().splitlines())}
    test_loader = create_sen12mscr_dataloaders(8, root=sen["root"], test=True)[1]
    data_range = test_loader.dataset.data_range
    gt01 = rescale_to_unit(np.asarray(next(iter(test_loader))["image"], np.float32), data_range)
    s01 = rescale_to_unit(res["samples"], data_range)
    cpu = {"ssim": float(M.ssim(s01, gt01)), "psnr": float(M.psnr(s01, gt01))}
    metrics_err = {k: abs(written[k] - v) / max(1.0, abs(v)) for k, v in cpu.items()}
    print(f"cli.inference --metrics --samples_fid on phase 7c's checkpoint (DDIM-4 b8, test "
          f"split): metrics.txt {written}; the CPU from the same samples {cpu}; scaled "
          f"errors {metrics_err} (tol {TOL_METRICS})", flush=True)
    assert written["length"] == 1 and max(metrics_err.values()) <= TOL_METRICS, metrics_err
    fid_dir = os.path.join(out, "samples_fid")
    assert sorted(os.listdir(fid_dir)) == sorted(f"sample_0-{i}.png" for i in range(8))

    # (b) cli.evaluate over two PNG directories, the offline extractor
    real_dir = os.path.join(tmp, "real_png")
    for i, im in enumerate(gt01):
        save_image_grid(im, os.path.join(real_dir, f"gt_{i}.png"))
    t0 = time.perf_counter()
    ev = cli_evaluate.main(cli_evaluate.parse_args([
        "--real", real_dir, "--fake", fid_dir, "--extractor", "offline", "--device", "cuda",
        "--out", os.path.join(tmp, "eval.json")]))
    eval_s = time.perf_counter() - t0
    assert ev["n_real"] == ev["n_fake"] == 8 and all(math.isfinite(v) for v in ev.values()), ev
    imgs = cli_evaluate.load_image_dir(fid_dir)
    proj = {d: M.tiny_feature_extractor(device=d)(imgs) for d in ("cuda", "cpu")}
    proj_err = rel_max(proj["cuda"], proj["cpu"])

    # (c) the FeatureCNN of eval_extractor256.npz (64 px tiles), card vs CPU
    params, meta = FC.load_params(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                               "gallery", "eval_extractor256.npz"))
    tile = int(meta["tile"])
    tiles = np.random.default_rng(10).uniform(size=(16, tile, tile, 3)).astype(np.float32)
    feats = {d: FC.make_extractor(params, device=d)(tiles) for d in ("cuda", "cpu")}
    fcnn_err = rel_max(feats["cuda"], feats["cpu"])

    # (d) InceptionV3 at 299 px, batch 8, seeded weights, card vs CPU
    model = seeded_inception(11)
    x = np.random.default_rng(12).uniform(size=(8, 256, 256, 3)).astype(np.float32)
    with torch.no_grad():
        ref = model(preprocess(x))
    inc = inception_feature_extractor(model.cuda(), batch_size=8, with_logits=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool3, probs = inc(x)
    inc_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        logits = model(preprocess(torch.from_numpy(x).cuda()))["logits"].cpu()
    inc_err = {"pool3": rel_max(pool3, ref["pool3"]), "logits": rel_max(logits, ref["logits"])}
    print(f"cli.evaluate --extractor offline (card), 8 real vs 8 samples: {json.dumps(ev)} in "
          f"{eval_s:.3f} s; the random projection card vs CPU {proj_err:.3e}, the FeatureCNN "
          f"of eval_extractor256.npz on {tile} px tiles b16 {fcnn_err:.3e}, InceptionV3 299 px "
          f"b8 {json.dumps(inc_err)} (tol {TOL_EVAL}; host {inc_ms:.3f} ms a batch with the "
          f"copies); {card}", flush=True)
    assert max(proj_err, fcnn_err, *inc_err.values()) <= TOL_EVAL, (proj_err, fcnn_err, inc_err)
    assert np.allclose(probs.sum(-1), 1.0, atol=1e-5)
    del model, inc
    torch.cuda.empty_cache()
    return {"metrics_txt": written, "metrics_cpu": cpu, "evaluate": ev,
            "projection_err": proj_err, "feature_cnn_err": fcnn_err, "inception_err": inc_err}


def write_geotiff(path, arr, deflate=False, rows_per_strip=16):
    """A baseline TIFF of the [H, W, S] uint16 or float32 array ``arr``:
    little endian, chunky, strips of ``rows_per_strip`` rows; uncompressed,
    or deflate with the horizontal predictor (uint16 only)."""
    h, w, s = arr.shape
    bits, fmt = (16, 1) if arr.dtype == np.uint16 else (32, 3)
    segs = []
    for r0 in range(0, h, rows_per_strip):
        seg = arr[r0:r0 + rows_per_strip]
        if deflate:  # each sample minus its left neighbour, in uint16 arithmetic
            seg = np.concatenate([seg[:, :1], np.diff(seg, axis=1)], axis=1)
            segs.append(zlib.compress(np.ascontiguousarray(seg).tobytes()))
        else:
            segs.append(np.ascontiguousarray(seg).tobytes())
    segs = [seg + b"\0" * (len(seg) & 1) for seg in segs]  # word-aligned offsets
    offsets = list(np.cumsum([8] + [len(seg) for seg in segs[:-1]]))
    end = 8 + sum(len(seg) for seg in segs)
    extra = bytearray()

    def entry(tag, typ, values):  # typ 3: SHORT, 4: LONG
        packed = struct.pack(f"<{len(values)}{'H' if typ == 3 else 'I'}", *values)
        if len(packed) <= 4:
            return struct.pack("<HHI", tag, typ, len(values)) + packed.ljust(4, b"\0")
        off = end + len(extra)
        extra.extend(packed)
        return struct.pack("<HHII", tag, typ, len(values), off)

    tags = [entry(256, 4, [w]), entry(257, 4, [h]), entry(258, 3, [bits] * s),
            entry(259, 3, [8 if deflate else 1]), entry(262, 3, [1]),
            entry(273, 4, [int(o) for o in offsets]), entry(277, 3, [s]),
            entry(278, 4, [rows_per_strip]), entry(279, 4, [len(seg) for seg in segs]),
            entry(284, 3, [1])] + ([entry(317, 3, [2])] if deflate else []) + [
            entry(339, 3, [fmt] * s)]
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, end + len(extra)))
        f.write(b"".join(segs) + bytes(extra))
        f.write(struct.pack("<H", len(tags)) + b"".join(tags) + struct.pack("<I", 0))


def write_sen12_tree(root, seed):
    """A SEN12MS-CR tree (``ROIs1868_summer/{s1,s2,s2_cloudy}_<scene>/
    ROIs1868_summer_<sensor>_<scene>_p<patch>.tif``): terrain of smooth
    reflectances plus noise in the clear view, a bright cloud over part of
    it in the cloudy view. s1 and s2 are written uncompressed, s2_cloudy
    with deflate and the predictor. Returns the written arrays of one
    triplet by sensor and the tree's size in bytes."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)
    season, n, cells = "ROIs1868_summer", SEN12_SIZE, SEN12_SIZE // 16
    one, jobs = None, []
    with ThreadPoolExecutor(max_workers=8) as pool:  # zlib releases the GIL
        for scene in range(1, SEN12_SCENES + 1):
            terrain = rng.integers(300, 4000, (cells, cells, 13)).repeat(16, 0).repeat(16, 1)
            for sensor in ("s1", "s2", "s2_cloudy"):
                os.makedirs(os.path.join(root, season, f"{sensor}_{scene}"), exist_ok=True)
            for patch in range(SEN12_PATCHES):
                clear = terrain + rng.integers(0, 400, (n, n, 13))
                cloud = np.clip(rng.normal(0, 1, (cells, cells)).repeat(16, 0).repeat(16, 1)
                                + rng.uniform(-1, 1), 0, 1)[..., None]
                arrays = {"s1": rng.normal(-12, 4, (n, n, 2)).astype(np.float32),
                          "s2": clear.astype(np.uint16),
                          "s2_cloudy": np.minimum(clear + 7000 * cloud, 10000).astype(np.uint16)}
                paths = {sensor: os.path.join(root, season, f"{sensor}_{scene}",
                                              f"{season}_{sensor}_{scene}_p{patch}.tif")
                         for sensor in arrays}
                for sensor, arr in arrays.items():
                    jobs.append(pool.submit(write_geotiff, paths[sensor], arr,
                                            deflate=sensor == "s2_cloudy"))
                if one is None:
                    one = {sensor: (paths[sensor], arr) for sensor, arr in arrays.items()}
        for job in jobs:
            job.result()
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, files in os.walk(root) for f in files)
    return one, nbytes


class FirstCall:
    """Records the arguments of the first call of ``owner.name`` (tensors
    copied to the host) while it is installed; the call itself goes on."""

    def __init__(self, owner, name, pick):
        self.owner, self.name, self.pick, self.seen = owner, name, pick, None

    def __enter__(self):
        real = self.real = getattr(self.owner, self.name)

        def wrapper(*args, **kwargs):
            if self.seen is None:
                self.seen = {k: (v.device.type, v.detach().cpu())
                             for k, v in self.pick(*args, **kwargs).items()}
            return real(*args, **kwargs)

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


def phase_7c(tmp, card, synthetic):
    """The SEN12MS-CR feed at full width: a GeoTIFF tree on disk, decoded by
    the port's native library, through the loader and device_prefetch into
    sen12mscr256 training at batch 8, sampling from its checkpoint on the
    test split's cloudy views, and the device cache. ``synthetic`` is phase
    7's result, whose steady steps/s it is printed beside."""
    import importlib.util

    import eo_diffusion_torch
    from eo_diffusion_torch.data import native
    from eo_diffusion_torch.data.device_cache import DeviceDataCache, gather_core
    from eo_diffusion_torch.data.factories import create_sen12mscr_dataloaders
    from eo_diffusion_torch.data.sen12ms_cr import S1Bands, S2Bands, _default_reader
    from eo_diffusion_torch.train import trainer as TR

    # (a) the tree
    root = os.path.join(tmp, "SEN12MS_CR")
    t0 = time.perf_counter()
    one, nbytes = write_sen12_tree(root, seed=7)
    write_s = time.perf_counter() - t0

    # (b) the decoder: the port's own build, bit for bit against the rasters
    lib = native.loaded_path()
    build_dir = os.path.join(os.path.dirname(eo_diffusion_torch.__file__), "_build")
    assert lib == str(native.library_path()) and os.path.dirname(lib) == build_dir, lib
    assert importlib.util.find_spec("rasterio") is None  # the reader's first choice is absent
    decode_ms = {}
    for sensor, (path, arr) in one.items():
        np.testing.assert_array_equal(native.read_tiff(path), arr.astype(np.float32))
        bands = list(S1Bands.ALL.value if sensor == "s1" else S2Bands.RGB.value)
        np.testing.assert_array_equal(_default_reader(path, bands),
                                      arr.astype(np.float32)[:, :, [b - 1 for b in bands]])
        t0 = time.perf_counter()
        for _ in range(10):
            native.read_tiff(path)
        decode_ms[sensor] = (time.perf_counter() - t0) * 100
    print(f"sen12mscr tree: {SEN12_SCENES * SEN12_PATCHES} triplets, {nbytes / 1e6:.1f} MB "
          f"written in {write_s:.2f} s; native decoder {os.path.basename(lib)} (built from "
          f"eo_diffusion_torch/data/csrc) bit-exact on s1, s2, s2_cloudy (deflate + "
          f"predictor); read_tiff ms a file {json.dumps(decode_ms)}", flush=True)

    # (c) the host feed alone: one epoch of the train loader at the factory's
    # defaults (num_workers 0, prefetch 2), then with 8 worker threads
    feed = {}
    for workers in (0, 8):
        loader = create_sen12mscr_dataloaders(8, root=root, num_workers=workers)[0]
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        feed[workers] = (time.perf_counter() - t0) * 1e3 / n
    assert n == 6, n
    print(f"sen12mscr host feed b8 (24 GeoTIFF decodes a batch), no model: "
          f"{feed[0]:.3f} ms a batch at num_workers 0, {feed[8]:.3f} ms at num_workers 8; "
          f"{card}", flush=True)

    # (d) training at full width from the tree: the first batch on the card is
    # the loader's, bit for bit
    steps = SEN12_EPOCHS * 6
    argv = ["--preset", "sen12mscr256", "--dataset", "sen12mscr", "--data_root", root,
            "--batch_size", "8", "--epochs", str(SEN12_EPOCHS), "--sample_every", "0",
            "--save_every", "0", "--model_ema_steps", "2", "--log_freq", "6", "--seed", "8",
            "--device", "cuda", "--dir", "results/train_sen12mscr"]
    reset_counts()
    with contextlib.chdir(tmp), FirstCall(TR.Trainer, "step",
                                          lambda self, state, batch: batch) as first:
        res = cli_train.main(cli_train.parse_args(argv))
    launched = counts()
    assert res["steps"] == steps and all(math.isfinite(x) for x in res["losses"]), res["losses"]
    cfg = get_preset("sen12mscr256").unet_config(cond_channels=3)
    assert launched == expected(256, steps, steps, cfg, 8), launched
    want = next(iter(create_sen12mscr_dataloaders(8, root=root)[0]))
    assert sorted(first.seen) == ["cond", "image"], sorted(first.seen)
    for key, ref in (("image", "image"), ("cond", "cond_image")):
        dev, got = first.seen[key]
        assert dev == "cuda" and got.dtype == torch.float32, (dev, got.dtype)
        np.testing.assert_array_equal(got.numpy(), want[ref])

    def steady(r):  # steps/s after cuDNN's plan search: steps alone, and with the feed
        st, wt = r["step_seconds"][2:], r["wait_seconds"][2:]
        return len(st) / sum(st), len(st) / (sum(st) + sum(wt)), 1e3 * sum(wt) / len(wt)

    sps, sps_fed, wait_ms = steady(res)
    syn_sps, syn_fed, syn_wait = steady(synthetic)
    print(f"training path sen12mscr256 b8 bf16 from GeoTIFFs: {steps} steps, loss "
          f"{res['losses'][0]:.5f} -> {res['losses'][-1]:.5f}; steady {sps:.4f} steps/s "
          f"(step alone), {sps_fed:.4f} steps/s with the feed ({wait_ms:.3f} ms a step "
          f"waiting for the batch); phase 7 synthetic: {syn_sps:.4f} and {syn_fed:.4f} "
          f"steps/s ({syn_wait:.3f} ms); launches {launched}; {card}", flush=True)

    # (e) sampling from its checkpoint, conditioned on the test split's cloudy views
    args = cli.parse_args(["--preset", "sen12mscr256", "--dataset", "sen12mscr", "--data_root",
                           root, "--ckpt", res["checkpoint"], "--sampler", "ddim",
                           "--sampler_steps", "4", "--batch_size", "8", "--n_iter", "0",
                           "--device", "cuda", "--seed", "8",
                           "--outdir", os.path.join(tmp, "out_sen12mscr")])
    reset_counts()
    with FirstCall(GaussianDiffusion, "ddim_sample",
                   lambda self, *a, **kw: {"cond": kw["cond"]}) as cond:
        sampled = cli.main(args)
    x = torch.as_tensor(sampled["samples"])
    assert x.shape == (8, 256, 256, 3) and bool(torch.isfinite(x).all()), x.shape
    assert counts() == expected(256, 4), counts()
    test_batch = next(iter(create_sen12mscr_dataloaders(8, root=root, test=True)[1]))
    dev, got = cond.seen["cond"]
    assert dev == "cuda"
    np.testing.assert_array_equal(got.numpy(), test_batch["cond_image"])

    # (f) the device cache: gathered on the card, equal to numpy's gather
    items = [create_sen12mscr_dataloaders(8, root=root, return_dataset=True)[0][i]
             for i in range(16)]
    data = {k: np.stack([it[k] for it in items]) for k in ("image", "cond_image")}
    cache = DeviceDataCache(data, "cuda")
    idx = np.array([5, 0, 15, 5, 9, 3, 12, 1])
    do_h = np.array([1, 0, 1, 0, 1, 0, 0, 1], bool)
    do_v = np.array([0, 0, 1, 1, 1, 0, 1, 0], bool)
    out = gather_core(cache.tensors, *(torch.from_numpy(a).cuda() for a in (idx, do_h, do_v)))
    for k, v in data.items():
        ref = v[idx]
        ref = np.where(do_h[:, None, None, None], ref[:, :, ::-1], ref)
        ref = np.where(do_v[:, None, None, None], ref[:, ::-1], ref)
        np.testing.assert_array_equal(out[k].cpu().numpy(), ref)
    g = torch.Generator(device="cuda").manual_seed(0)
    gather_ms = cuda_ms(lambda: cache.sample_batch(g, 8), reps=20)
    print(f"device cache: 16 triplets, {cache.nbytes() / 2**20:.1f} MiB on the card; "
          f"gather_core bit-exact against numpy; gather_batch b8 {gather_ms:.4f} ms; "
          f"sampling from the checkpoint on the test split's cloudy views: DDIM-4 b8 "
          f"{sampled['sample_seconds']:.3f} s, launches {counts()}; {card}", flush=True)
    return {"feed_ms": feed, "decode_ms": decode_ms, "sps": sps, "sps_fed": sps_fed,
            "synthetic_sps": syn_sps, "synthetic_sps_fed": syn_fed, "gather_ms": gather_ms,
            "root": root, "checkpoint": res["checkpoint"]}


def run_tiled(cfg, seed, gen, n, steps):
    """tiled_ddim_sample of n 512 x 512 scenes with the 256 px denoiser
    (3 x 3 tiles at overlap 0.5, one model call a step over all tiles),
    concat cond, the weights of the whole-scene run."""
    model = randomize_parameters(UNet(cfg), seed).cuda().eval()
    diffusion = GaussianDiffusion.create(timesteps=1000, image_size=256, cond_type="concat")
    cond = torch.randn(n, 512, 512, 3, generator=gen, device="cuda").clamp(-1, 1)
    model_fn = lambda x, t, c, y: model(x, t, cond=c, y=y)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        x = tiled_ddim_sample(diffusion, model_fn, n, 512, 512, device="cuda", generator=gen,
                              num_steps=steps, cond=cond).x.float().cpu()
        seconds = time.perf_counter() - t0
    launched = counts()
    assert x.shape == (n, 512, 512, 3) and bool(torch.isfinite(x).all()), x.shape
    assert launched == expected(256, steps), launched
    return {"seconds": seconds, "images": n, "launches": launched,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def run_cli(argv, cfg, seed, tmp, ckpt=None):
    """Run the inference entry point in-process with seeded random weights
    (saved as a state dict and passed with --ckpt), or from ``ckpt``."""
    if ckpt is None:
        ckpt = os.path.join(tmp, f"weights_{cfg.__class__.__name__}_{hash(cfg)}_{seed}.pt")
        if not os.path.exists(ckpt):  # one save a config and seed
            torch.save(randomize_parameters(build_denoiser(cfg), seed).state_dict(), ckpt)
    args = cli.parse_args(argv + ["--ckpt", ckpt, "--outdir", os.path.join(tmp, "out"),
                                  "--seed", str(seed)])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hits = A.identity_attention_hits()
    res = cli.main(args)
    res["launches"] = counts()
    res["identity_hits"] = A.identity_attention_hits() - hits
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    x = res["samples"]
    assert x is not None and bool(torch.isfinite(torch.as_tensor(x)).all()), "non-finite samples"
    return res


def unet_expected(cfg, full=0, partial=0, perturbed=0):
    """The launch counts of ``full`` UNet forwards, ``partial`` DeepCache
    calls (the shallow blocks of the default depth) and ``perturbed`` PAG
    calls (every norm, no attention) of ``cfg``'s UNet: the attention
    launches of a forward from UNET_ATTN (written out, not read from the
    router), which must cover every attention block of the plan."""
    plan = build_unet_plan(cfg)
    attn, norms = plan.sites()
    key = (cfg.image_size, cfg.model_channels, tuple(cfg.channel_mult),
           tuple(cfg.attention_resolutions))
    per = UNET_ATTN[key]
    if cfg.dtype == torch.float32:  # K1-K3 in float32: the tensor-core float32 kernel
        per = {F32_KEYS.get(k, k): n for k, n in per.items()}
    assert sum(per.values()) == attn, (key, per, plan.attention_shapes(cfg.image_size))
    _, shallow = plan.sites(1 + cfg.num_res_blocks)
    return {**{k: 0 for k in counts()}, **{k: n * full for k, n in per.items()},
            "gn_fwd": norms * (full + perturbed) + shallow * partial}


def solver_plain_check(cfg, gen, card):
    """DPM-Solver++(2M)-20 and UniPC-10 on the clouds UNet at 256 px, batch 8,
    the kernels against the all-plain model (``UNet.set_impl``) from the same
    x_T and cloudy view, by the relative L2 of the final samples, held to
    SOLVER_NOISE_FACTOR times the noise floor of the same trajectory: the
    plain model's trajectory against itself with every model output given
    relative noise of the size one kernel forward parts from plain (read
    here at t 500, and held to TOL_UNET_REL before the floor is built).
    Also one DeepCache partial call on a fresh cache against the full call,
    to TOL_UNET_REL, and whether it gives the same bits."""
    size = cfg.image_size
    model = randomize_parameters(UNet(cfg), seed=2).to("cuda").eval()
    diffusion = GaussianDiffusion.create(timesteps=1000, image_size=size, cond_type="concat")
    cond = torch.randn(8, size, size, 3, generator=gen, device="cuda").clamp(-1, 1)
    x = torch.randn(8, size, size, 3, generator=gen, device="cuda")
    t = torch.full((8,), 500, device="cuda")
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    out, failed = {}, []
    with torch.inference_mode():
        fwd_k = model(x, t, cond=cond)
        fwd_p = model.set_impl(attn="plain", norm="plain")(x, t, cond=cond)
        model.set_impl(attn="auto", norm="auto")
        out["forward_rel_l2"] = d_fwd = rel(fwd_k, fwd_p)
        # the floor is built from this reading, so it is first held to the
        # fixed forward limit: a wrong kernel cannot widen its own limit
        assert d_fwd <= TOL_UNET_REL, (d_fwd, TOL_UNET_REL)
        for name, steps, calls in (("dpm", 20, 20), ("unipc", 10, 11)):
            sample = getattr(diffusion, f"{name}_sample")
            noise = torch.Generator(device="cuda").manual_seed(7)
            noisy = lambda x, t, c, y: (lambda o: o * (1 + d_fwd * torch.randn(
                o.shape, generator=noise, device="cuda", dtype=o.dtype)))(model(x, t, cond=c))
            run = lambda fn: sample(fn, 8, device="cuda", num_steps=steps, cond=cond,
                                    generator=torch.Generator(device="cuda").manual_seed(5)).x
            reset_counts()
            x_k = run(lambda x, t, c, y: model(x, t, cond=c))
            launched = counts()
            model.set_impl(attn="plain", norm="plain")
            x_p, x_n = run(lambda x, t, c, y: model(x, t, cond=c)), run(noisy)
            model.set_impl(attn="auto", norm="auto")
            assert counts() == launched == unet_expected(cfg, full=calls), (name, launched)
            reading, floor = rel(x_k, x_p), rel(x_n, x_p)
            ok = bool(torch.isfinite(x_k).all()) and reading <= SOLVER_NOISE_FACTOR * floor
            print(f"5f {name}-{steps} b8 kernels vs all-plain: final samples rel L2 {reading:.3e}; "
                  f"the trajectory's noise floor {floor:.3e} (plain with every output given "
                  f"rel noise {d_fwd:.3e}, the forward's reading); limit "
                  f"{SOLVER_NOISE_FACTOR} x floor = {SOLVER_NOISE_FACTOR * floor:.3e}: "
                  f"{'held' if ok else 'FAILED'}; {card}", flush=True)
            out[f"{name}{steps}_rel_l2"], out[f"{name}{steps}_noise_floor"] = reading, floor
            if not ok:
                failed.append((name, reading, floor))
        full, deep = model(x, t, cond=cond, return_deep=True)
        reset_counts()
        part = model(x, t, cond=cond, deep_cache=deep)
        assert counts() == unet_expected(cfg, partial=1), counts()
    r = rel(part, full)
    out.update(deepcache_partial_rel_l2=r, deepcache_partial_bit_exact=bool(torch.equal(part, full)))
    print(f"5f DeepCache partial call on a fresh cache vs the full call: rel L2 {r:.3e} "
          f"(tol {TOL_UNET_REL}), same bits: {out['deepcache_partial_bit_exact']}", flush=True)
    assert torch.isfinite(part).all() and r <= TOL_UNET_REL, r
    assert not failed, failed
    return out


def run_train_posthoc(tmp, seed, card):
    """``cli.train --preset sen12mscr256 --posthoc_ema`` at batch 8 for
    PHEMA_STEPS steps, snapshots at every second step: the tracks for 5f's
    ``--phema_sigma_rel`` and ``--autoguide_sigma_rel`` runs."""
    argv = ["--preset", "sen12mscr256", "--dataset", "synthetic", "--batch_size", "8",
            "--epochs", "1", "--steps_per_epoch", str(PHEMA_STEPS), "--sample_every", "0",
            "--save_every", "2", "--model_ema_steps", "1", "--log_freq", "1", "--posthoc_ema",
            "--seed", str(seed), "--device", "cuda", "--dir", "results/phema_smoke"]
    reset_counts()
    with contextlib.chdir(tmp):
        res = cli_train.main(cli_train.parse_args(argv))
    cfg = get_preset("sen12mscr256").unet_config(cond_channels=3)
    want = expected(256, PHEMA_STEPS, PHEMA_STEPS, cfg, 8)
    assert counts() == want, (counts(), want)
    phema_dir = os.path.join(os.path.dirname(res["checkpoint"]), "phema")
    snaps = sorted(os.listdir(phema_dir))
    assert len(snaps) == 2 * (PHEMA_STEPS // 2), snaps
    # the tracks' update, inside every --posthoc_ema step: its cost beside
    # the step's (steady steps, after the first two)
    params = dict(res["state"].model.named_parameters())
    ema = PowerEMA()
    tracks = ema.init(params)
    update_ms = cuda_ms(lambda: ema.update(tracks, params, 10), reps=20)
    step_ms = 1e3 * sum(res["step_seconds"][2:]) / len(res["step_seconds"][2:])
    print(f"5f PowerEMA.update ({len(ema.gammas)} tracks of {len(params)} tensors, "
          f"{sum(p.numel() for p in params.values())} parameters): {update_ms:.4f} ms, "
          f"the --posthoc_ema train step {step_ms:.4f} ms (mean of steps 3-{PHEMA_STEPS}); "
          f"{card}", flush=True)
    del res["state"]
    return res["checkpoint"], snaps, {"update_ms": update_ms, "step_ms": step_ms}


def phase_5f(tmp, card, gen, main_img_s):
    """The sampling CLI's solvers and guidance on ``sen12mscr256`` (the
    clouds UNet at full width and depth, concat cloud removal, 256 px, batch
    8, two batches a run, seeded weights), then the class-conditional and
    v-prediction presets at their own widths, and tiled sampling with CFG and
    DeepCache. Each run's launches are asserted against the counts derived
    from ``build_unet_plan`` and the sampler; img/s over the second batch."""
    sen = get_preset("sen12mscr256")
    cfg = sen.unet_config(cond_channels=3)
    sites = build_unet_plan(cfg).sites()
    assert sites == (ROUTES[256][0], GN_PER_FORWARD), sites
    base = ["--preset", "sen12mscr256", "--dataset", "synthetic", "--batch_size", "8",
            "--n_iter", "1", "--device", "cuda"]
    out, runs = {"plain_checks": solver_plain_check(cfg, gen, card)}, {}

    def drive(tag, argv, want, model_cfg=cfg, ckpt=None, hits=0):
        res = run_cli(argv, model_cfg, seed=2, tmp=tmp, ckpt=ckpt)
        assert res["launches"] == want, (tag, res["launches"], want)
        assert res["identity_hits"] == hits, (tag, res["identity_hits"], hits)
        assert res["batches"] == 2, res["batches"]
        res["img_s"] = 8 / res["batch_seconds"][1]
        print(f"5f {tag} b8: batch seconds {[round(x, 4) for x in res['batch_seconds']]}, "
              f"{res['img_s']:.4f} img/s (second batch), launches "
              f"{ {k: v for k, v in res['launches'].items() if v} }, identity hits "
              f"{res['identity_hits']}, peak memory {res['peak_mem_gb']:.2f} GiB; {card}",
              flush=True)
        del res["samples"]
        runs[tag] = res

    for tag, flags, full in (
            ("ddim50", ["--sampler", "ddim", "--sampler_steps", "50"], 50),
            ("dpm20-uniform_lambda", ["--sampler", "dpm", "--sampler_steps", "20"], 20),
            ("dpm20-karras", ["--sampler", "dpm", "--sampler_steps", "20", "--dpm_spacing",
                              "karras"], 20),
            ("unipc10", ["--sampler", "unipc", "--sampler_steps", "10"], 11),
            # image-CFG against the zero cloudy view: K1 at B16, 11 a step
            ("cfg3-rescale0.7-interval-ddim20", ["--sampler", "ddim", "--sampler_steps", "20",
                                                 "--guidance_scale", "3", "--guidance_rescale",
                                                 "0.7", "--guidance_interval", "0.2,0.8"], 20),
            ("dynamic-threshold-ddim20", ["--sampler", "ddim", "--sampler_steps", "20",
                                          "--dynamic_threshold", "0.995"], 20)):
        drive(tag, base + flags, unet_expected(cfg, full=2 * full))
    # DeepCache k=3 on DDIM-50, the protocol of bench.py's deepcache_k3 rider:
    # the deep branch at steps 0, 3, ..., 48 (17), the shallow blocks at the 33 others
    full = sum(i % 3 == 0 for i in range(50))
    drive("deepcache3-ddim50", base + ["--sampler", "ddim", "--sampler_steps", "50",
                                       "--deepcache", "3"],
          unet_expected(cfg, full=2 * full, partial=2 * (50 - full)))
    print(f"5f DeepCache-3 DDIM-50 b8 {runs['deepcache3-ddim50']['img_s']:.4f} img/s against "
          f"DDIM-50 {runs['ddim50']['img_s']:.4f} (5f, second batch) and phase 5's "
          f"{main_img_s:.4f} (one batch); {card}", flush=True)
    # PAG: each step one call through the kernels, one perturbed (no K1)
    drive("pag2-ddim10", base + ["--sampler", "ddim", "--sampler_steps", "10", "--pag_scale",
                                 "2"],
          unet_expected(cfg, full=2 * 10, perturbed=2 * 10),
          hits=2 * 10 * sites[0])
    k = sdedit_plan(make_ddim_schedule(GaussianDiffusion.create(timesteps=1000).schedule, 20,
                                       0.0).num_steps, 0.5)
    drive("sdedit0.5-ddim20", base + ["--sampler", "ddim", "--sampler_steps", "20",
                                      "--sdedit_strength", "0.5"], unet_expected(cfg, full=2 * k))
    out["sdedit_calls"] = k
    # post-hoc EMA: a short training run of its own writes the snapshots
    ckpt, snaps, out["phema_update"] = run_train_posthoc(tmp, seed=16, card=card)
    out["phema_snapshots"] = snaps
    drive("phema0.1-ddim10", base + ["--sampler", "ddim", "--sampler_steps", "10",
                                     "--phema_sigma_rel", "0.1"],
          unet_expected(cfg, full=2 * 10), ckpt=ckpt)
    drive("autoguide2-sigma0.05-ddim10", base + ["--sampler", "ddim", "--sampler_steps", "10",
                                                 "--autoguide_scale", "2",
                                                 "--autoguide_sigma_rel", "0.05"],
          unet_expected(cfg, full=2 * 2 * 10), ckpt=ckpt)
    # class-conditional (label-CFG against the null row) and v-prediction
    # presets at their own widths, 64 px
    for preset, flags, calls in (
            ("cddpm64", ["--sampler", "ddim", "--sampler_steps", "20", "--guidance_scale", "4"],
             20),
            ("cddpm64", ["--sampler", "dpm", "--sampler_steps", "20", "--guidance_scale", "4"],
             20),
            ("cflow64", ["--flow_method", "heun", "--sampler_steps", "8", "--guidance_scale",
                         "3"], 15),
            ("vpred64", ["--sampler", "dpm", "--sampler_steps", "20"], 20)):
        pcfg = get_preset(preset).model_config(
            class_dropout_prob=get_preset(preset).class_dropout)
        drive(f"{preset} {' '.join(flags)}",
              ["--preset", preset, "--dataset", "synthetic", "--batch_size", "8",
               "--n_iter", "1", "--device", "cuda", *flags],
              unet_expected(pcfg, full=2 * calls), model_cfg=pcfg)
    out["runs"] = runs
    out["tiled"] = run_tiled_guided(cfg, gen, card)
    return out


def run_tiled_guided(cfg, gen, card, steps=20, refresh=3, tile_batch=6):
    """tiled_ddim_sample of one 512 x 512 scene (3 x 3 tiles of 256 at
    overlap 0.5) with image-CFG and DeepCache: the tiles in chunks of
    ``tile_batch``, one DeepCache state a chunk, each chunk doubled by CFG."""
    size = cfg.image_size
    model = randomize_parameters(UNet(cfg), seed=2).to("cuda").eval()
    diffusion = GaussianDiffusion.create(timesteps=1000, image_size=size, cond_type="concat")
    cond = torch.randn(1, 2 * size, 2 * size, 3, generator=gen, device="cuda").clamp(-1, 1)
    fn, state0 = deepcache_model_fn(model, refresh_every=refresh)
    n_chunks = -(-9 // tile_batch)
    full = sum(i % refresh == 0 for i in range(steps))
    reset_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        x = tiled_ddim_sample(diffusion, fn, 1, 2 * size, 2 * size, device="cuda", generator=gen,
                              num_steps=steps, cond=cond, uncond=torch.zeros_like(cond),
                              guidance_scale=3.0, tile_batch=tile_batch,
                              model_state=state0).x.float().cpu()
        seconds = time.perf_counter() - t0
    launched = counts()
    want = unet_expected(cfg, full=n_chunks * full, partial=n_chunks * (steps - full))
    assert x.shape == (1, 2 * size, 2 * size, 3) and bool(torch.isfinite(x).all()), x.shape
    assert launched == want, (launched, want)
    print(f"5f tiled_ddim_sample 512x512 CFG 3 + DeepCache {refresh}, DDIM-{steps}, tile batch "
          f"{tile_batch} ({n_chunks} chunks, one state each): {seconds:.3f} s, launches "
          f"{ {k: v for k, v in launched.items() if v} }; {card}", flush=True)
    return {"seconds": seconds, "launches": launched}


def plain_trajectory_check(model, cfg, run, calls, tag, card):
    """``run(model_fn)`` (a sampler from fixed weights and a fixed start)
    through the kernels, then through the all-plain model: the launches of
    the kernel run are ``calls`` UNet forwards, the plain run launches
    nothing, and the final samples agree within TOL_SOLVER_REL (relative
    L2). Returns the reading and the kernel run's seconds and launches."""
    fn = lambda x, t, c, y: model(x, t, cond=c, y=y)
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    with torch.inference_mode():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_k = run(fn)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts()
        model.set_impl(attn="plain", norm="plain")
        x_p = run(fn)
        model.set_impl(attn="auto", norm="auto")
    assert counts() == launched == unet_expected(cfg, full=calls), (tag, launched)
    reading = rel(x_k, x_p)
    ok = bool(torch.isfinite(x_k).all()) and reading <= TOL_SOLVER_REL
    print(f"5g {tag} kernels vs all-plain: final samples rel L2 {reading:.3e} (limit "
          f"{TOL_SOLVER_REL}): {'held' if ok else 'FAILED'}; {calls} model calls, "
          f"{seconds:.4f} s; {card}", flush=True)
    assert ok, (tag, reading)
    return {"rel_l2": reading, "seconds": seconds, "launches": launched}


def run_demo(name, argv, cfg, calls, tmp, card):
    """One of examples/torch's demos in process on the card, with the
    launches its UNet gives for ``calls`` forwards; its files written and
    its output finite."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "torch", name)
    spec = importlib.util.spec_from_file_location(f"_demo_{name[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = os.path.join(tmp, f"demo_{name[:-3]}")
    reset_counts()
    t0 = time.perf_counter()
    res = mod.main(["--synthetic", "--out", out, "--device", "cuda", *argv])
    seconds = time.perf_counter() - t0
    launched = counts()
    assert np.isfinite(res).all(), name
    assert launched == unet_expected(cfg, full=calls), (name, launched)
    files = sorted(os.listdir(out))
    assert files and all(os.path.getsize(os.path.join(out, f)) > 0 for f in files), files
    print(f"5g {name} {' '.join(argv)} (unet_clouds(64)) on the card: {files}, {seconds:.3f} s "
          f"with the model's build, launches {launched['attn_fwd']} K1 / {launched['gn_fwd']} "
          f"K5; {card}", flush=True)
    return {"files": files, "seconds": seconds, "launches": launched}


def phase_5g(tmp, card):
    """EDM and the Brownian bridge at full width: ``edm64`` and ``bridge64``
    through ``cli.train`` (EDM_BRIDGE_STEPS steps at batch 64) and
    ``cli.inference`` from the trained checkpoint (EDM Heun-18, the bridge's
    50 steps at eta 0, two batches of 8, img/s over the second), the
    launches of each asserted; the two processes and ``tiled_bridge_sample``
    with seeded weights against the all-plain model from the same start;
    the change-pair and inpainting demos on the card. K1 and K5 at the 64 px
    UNet's shapes against their plain versions first. Draws from a
    generator of its own, so every earlier check keeps its inputs."""
    bf16 = torch.bfloat16
    egen = torch.Generator(device="cuda").manual_seed(16)
    out = {"attn_rows": [attention_case(8, 256, 4, 48, bf16, False, egen),
                         attention_case(8, 64, 4, 64, bf16, False, egen)],
           "gn_rows": [gn_case(n, hw, c, 32, act, bf16, egen)
                       for n in (8, EDM_BRIDGE_BATCH) for hw, c, act in EDM64_GN_SITES],
           "runs": {}}
    torch.cuda.empty_cache()
    for preset, flags, calls in (
            ("edm64", ["--flow_method", "heun", "--sampler_steps", str(EDM_HEUN_STEPS)],
             EDM_HEUN_CALLS),
            ("bridge64", ["--sampler_steps", str(BRIDGE_STEPS), "--eta", "0"], BRIDGE_STEPS)):
        pre = get_preset(preset)
        cfg = pre.model_config(cond_channels=3 if pre.cond_type == "concat" else 0)
        assert build_unet_plan(cfg).sites() == (7, 36), build_unet_plan(cfg).sites()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with contextlib.chdir(tmp):
            tr = cli_train.main(cli_train.parse_args(
                train_argv(preset, EDM_BRIDGE_BATCH, EDM_BRIDGE_STEPS, 17, f"train_{preset}")))
        got = counts()
        want = unet_train_expected(cfg, 64, EDM_BRIDGE_BATCH, EDM_BRIDGE_STEPS)
        assert tr["steps"] == EDM_BRIDGE_STEPS and all(math.isfinite(x) for x in tr["losses"])
        assert got == want and want["attn_bwd"] and want["gn_bwd"] and want["wgrad_sm90"], (
            preset, got, want)
        step_ms = 1e3 * sum(tr["step_seconds"][2:]) / len(tr["step_seconds"][2:])
        print(f"5g cli.train {preset} b{EDM_BRIDGE_BATCH} bf16: {tr['steps']} steps, loss "
              f"{tr['losses'][0]:.5f} -> {tr['losses'][-1]:.5f}; {step_ms:.4f} ms a step (mean "
              f"of steps 3-{EDM_BRIDGE_STEPS}); launches { {k: v for k, v in got.items() if v} }; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}",
              flush=True)
        args = cli.parse_args(["--preset", preset, "--dataset", "synthetic", *flags,
                               "--batch_size", "8", "--n_iter", "1", "--device", "cuda",
                               "--ckpt", tr["checkpoint"], "--seed", "17",
                               "--outdir", os.path.join(tmp, f"out_{preset}")])
        reset_counts()
        smp = cli.main(args)
        sampled = counts()
        x = torch.as_tensor(smp["samples"])
        assert x.shape == (8, 64, 64, 3) and bool(torch.isfinite(x).all()), x.shape
        assert smp["batches"] == 2 and sampled == unet_expected(cfg, full=2 * calls), (
            preset, sampled)
        img_s = 8 / smp["batch_seconds"][1]
        print(f"5g cli.inference {preset} {' '.join(flags)} b8 from the trained checkpoint: "
              f"batch seconds {[round(v, 4) for v in smp['batch_seconds']]}, {img_s:.4f} img/s "
              f"(second batch), {calls} model calls a batch, launches "
              f"{ {k: v for k, v in sampled.items() if v} }; {card}", flush=True)
        out["runs"][preset] = {"train_launches": got, "sample_launches": sampled,
                               "train_step_ms": step_ms, "losses": tr["losses"],
                               "img_s": img_s, "batch_seconds": smp["batch_seconds"]}

        # the kernels against the all-plain model, seeded weights, one start
        model = randomize_parameters(UNet(cfg), seed=18).cuda().eval()
        if preset == "edm64":
            proc = EDMProcess.create(image_size=64)
            x_T = 80.0 * torch.randn(8, 64, 64, 3, generator=egen, device="cuda")
            run = lambda fn: proc.sample(fn, 8, device="cuda", num_steps=EDM_HEUN_STEPS,
                                         method="heun", x_T=x_T).x
            out["runs"][preset]["plain"] = plain_trajectory_check(
                model, cfg, run, calls, f"edm64 Heun-{EDM_HEUN_STEPS} b8", card)
            continue
        proc = BrownianBridge.create(image_size=64, timesteps=pre.timesteps)
        y = torch.randn(8, 64, 64, 3, generator=egen, device="cuda").clamp(-1, 1)
        run = lambda fn: proc.sample(fn, 8, device="cuda", num_steps=BRIDGE_STEPS, cond=y,
                                     eta=0.0).x
        out["runs"][preset]["plain"] = plain_trajectory_check(
            model, cfg, run, calls, f"bridge64 {BRIDGE_STEPS} steps eta 0 b8", card)
        h, w = TILED_BRIDGE_SCENE
        scene = torch.randn(1, h, w, 3, generator=egen, device="cuda").clamp(-1, 1)
        run = lambda fn: tiled_bridge_sample(proc, fn, 1, h, w, device="cuda",
                                             num_steps=TILED_BRIDGE_STEPS, cond=scene).x
        out["tiled"] = plain_trajectory_check(
            model, cfg, run, TILED_BRIDGE_STEPS,
            f"tiled_bridge_sample {h}x{w} (21 tiles of 64) {TILED_BRIDGE_STEPS} steps", card)
        del model
    torch.cuda.empty_cache()

    calls = make_ddim_schedule(GaussianDiffusion.create(timesteps=1000).schedule,
                               DEMO_DDIM_STEPS, 0.0).num_steps
    out["demos"] = {
        "change_pair": run_demo("change_pair_demo.py", ["--ddim", str(DEMO_DDIM_STEPS)],
                                unet_clouds(64, in_channels=6, dtype=bf16), calls, tmp, card),
        "inpainting": run_demo("inpainting_demo.py", ["--sampler", "ddim", "--ddim_steps",
                                                      str(DEMO_DDIM_STEPS)],
                               unet_clouds(64, dtype=bf16), calls, tmp, card)}
    return out


def clf_expected(forwards=0, grads=0, train_steps=0):
    """The launch counts of ``forwards`` classifier forwards without
    autograd, ``grads`` input gradients (a forward with the lse and its
    backward) and ``train_steps`` training steps (the same kernels as an
    input gradient; no weight-gradient kernel: the convs are float32)."""
    with_grad = grads + train_steps
    return {**{k: 0 for k in counts()}, "attn_fwd_f32": CLF_ATTN * (forwards + with_grad),
            "attn_bwd_f32": CLF_ATTN * with_grad, "gn_fwd": CLF_NORMS * (forwards + with_grad),
            "gn_bwd": CLF_NORMS * with_grad}


def add_counts(*parts):
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def phase_5h(tmp, card):
    """Classifier guidance and DDNM restoration at full width: K1 with the
    lse, K4 and K5 at the float32 classifier's shapes against their plain
    versions; ``cli.train_classifier --preset synthetic64 --class_correlated``
    at the preset's batch; the classifier's input gradient at b8 through the
    kernels against the all-plain classifier; guided DDIM-50 through
    ``cli.inference --classifier_ckpt --classifier_scale`` beside the
    unguided run, and the guided sampler against the all-plain denoiser and
    classifier from one start; ``cli.restore`` for sr4, inpaint and colorize
    on synthetic64 and inpaint on inria64, each against the all-plain model
    from one start and draw. Draws from a generator of its own."""
    from eo_diffusion_torch.cli import restore as cli_restore
    from eo_diffusion_torch.cli import train_classifier as cli_clf
    from eo_diffusion_torch.diffusion import inverse as INV
    from eo_diffusion_torch.diffusion.classifier_guidance import classifier_guided, log_prob_grad

    f32 = torch.float32
    hgen = torch.Generator(device="cuda").manual_seed(17)
    out = {"attn_rows": [attention_case(8, 256, 4, 48, f32, False, hgen, with_lse=True),
                         attention_case(8, 64, 4, 64, f32, False, hgen, with_lse=True)],
           "bwd_rows": [attention_bwd_case(8, 256, 4, 48, f32, False, hgen, hgen),
                        attention_bwd_case(8, 64, 4, 64, f32, False, hgen, hgen)],
           "gn_rows": [gn_case(8, hw, c, 32, act, f32, hgen) for hw, c, act in EDM64_GN_SITES],
           "runs": {}}
    torch.cuda.empty_cache()

    # training through the entry point, at the preset's batch
    pre = get_preset(CLF_PRESET)
    cdir = os.path.join(tmp, "classifier")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    meta = cli_clf.main(cli_clf.parse_args([
        "--preset", CLF_PRESET, "--class_correlated", "--steps", str(CLF_TRAIN_STEPS),
        "--eval_n", str(CLF_EVAL_N), "--dir", cdir, "--device", "cuda"]))
    got = counts()
    want = clf_expected(forwards=3, train_steps=CLF_TRAIN_STEPS)
    assert got == want, (got, want)
    assert math.isfinite(meta["final_loss"]), meta
    print(f"5h cli.train_classifier {CLF_PRESET} b{pre.batch_size} f32: {CLF_TRAIN_STEPS} steps "
          f"at {meta['steps_per_s']:.4f} steps/s after the first, final loss "
          f"{meta['final_loss']:.5f}, eval accuracy {json.dumps(meta['eval_acc'])}; launches "
          f"{ {k: v for k, v in got.items() if v} }; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}", flush=True)
    out["runs"]["train"] = {"launches": got, "meta": meta}

    # the input gradient at b8: kernels against the all-plain classifier
    clf, _ = cli_clf.load_classifier(cdir, "cuda")
    x = torch.randn(8, 64, 64, 3, generator=hgen, device="cuda")
    t = torch.randint(0, pre.timesteps, (8,), generator=hgen, device="cuda")
    y = torch.arange(8, device="cuda") % 5
    with torch.inference_mode():
        reset_counts()
        g_k = log_prob_grad(clf, x, t, y)
        launched = counts()
        clf.set_impl(attn="plain", norm="plain")
        g_p = log_prob_grad(clf, x, t, y)
        clf.set_impl(attn="auto", norm="auto")
    assert counts() == launched == clf_expected(grads=1), launched
    grad_rel = rel_l2(g_k, g_p)
    assert bool(torch.isfinite(g_k).all()) and grad_rel <= TOL_UNET_GRAD_REL, grad_rel
    print(f"5h classifier input gradient b8 (K1 with the lse, K4, K5 both ways): rel L2 "
          f"{grad_rel:.3e} against the all-plain classifier (limit {TOL_UNET_GRAD_REL}); "
          f"launches {CLF_ATTN} K1 / {CLF_ATTN} K4 / {CLF_NORMS} K5 fwd / {CLF_NORMS} K5 bwd "
          f"a gradient: {launched}; {card}", flush=True)
    out["grad"] = {"rel_l2": grad_rel, "launches": launched}

    # guided sampling through the entry point, beside the unguided run
    cfg = pre.model_config()
    calls = make_ddim_schedule(GaussianDiffusion.create(timesteps=pre.timesteps).schedule,
                               GUIDED_STEPS, 0.0).num_steps
    argv = ["--preset", CLF_PRESET, "--dataset", "synthetic", "--sampler", "ddim",
            "--sampler_steps", str(GUIDED_STEPS), "--batch_size", "8", "--n_iter", "1",
            "--device", "cuda"]
    for tag, extra, want in (
            ("unguided", [], unet_expected(cfg, full=2 * calls)),
            ("guided", ["--classifier_ckpt", cdir, "--classifier_scale", str(CLF_SCALE)],
             add_counts(unet_expected(cfg, full=2 * calls), clf_expected(grads=2 * calls)))):
        res = run_cli(argv + extra, cfg, seed=19, tmp=tmp)
        assert res["samples"].shape == (8, 64, 64, 3) and res["launches"] == want, (
            tag, res["launches"], want)
        res["img_s"] = 8 / res["batch_seconds"][1]
        print(f"5h cli.inference {CLF_PRESET} DDIM-{GUIDED_STEPS} b8 {tag}"
              f"{' scale ' + str(CLF_SCALE) if extra else ''}: batch seconds "
              f"{[round(v, 4) for v in res['batch_seconds']]}, {res['img_s']:.4f} img/s "
              f"(second batch), launches { {k: v for k, v in res['launches'].items() if v} }, "
              f"a step { {k: v / (2 * calls) for k, v in res['launches'].items() if v} }; "
              f"{card}", flush=True)
        out["runs"][tag] = {k: res[k] for k in ("launches", "img_s", "batch_seconds")}

    # the guided sampler against the all-plain denoiser and classifier
    model = randomize_parameters(UNet(cfg), seed=19).cuda().eval()
    proc = GaussianDiffusion.create(timesteps=pre.timesteps, image_size=64)
    x_T = torch.randn(8, 64, 64, 3, generator=hgen, device="cuda")
    fn = lambda xx, tt, c, yy: model(xx, tt, cond=c, y=yy)
    run = lambda: proc.ddim_sample(classifier_guided(proc, fn, clf, y, CLF_SCALE), 8,
                                   device="cuda", num_steps=GUIDED_STEPS, x_T=x_T).x
    with torch.inference_mode():
        reset_counts()
        x_k = run()
        launched = counts()
        model.set_impl(attn="plain", norm="plain")
        clf.set_impl(attn="plain", norm="plain")
        x_p = run()
        model.set_impl(attn="auto", norm="auto")
        clf.set_impl(attn="auto", norm="auto")
    guided_rel = rel_l2(x_k, x_p)
    assert counts() == launched, launched
    assert bool(torch.isfinite(x_k).all()) and guided_rel <= TOL_SOLVER_REL, guided_rel
    print(f"5h guided DDIM-{GUIDED_STEPS} b8 scale {CLF_SCALE} kernels vs all-plain (denoiser "
          f"and classifier): final samples rel L2 {guided_rel:.3e} (limit {TOL_SOLVER_REL}, "
          f"phase 5g's); {card}", flush=True)
    out["guided_plain"] = {"rel_l2": guided_rel, "launches": launched}
    del model
    torch.cuda.empty_cache()

    # DDNM restoration through the entry point, each against the all-plain model
    out["restore"] = {}
    for preset, task in ((CLF_PRESET, "sr4"), (CLF_PRESET, "inpaint"),
                         (CLF_PRESET, "colorize"), ("inria64", "inpaint")):
        rcfg = get_preset(preset).model_config()
        ckpt = os.path.join(tmp, f"restore_{preset}.pt")
        if not os.path.exists(ckpt):
            torch.save(randomize_parameters(build_denoiser(rcfg), 20).state_dict(), ckpt)
        reset_counts()
        res = cli_restore.main(cli_restore.parse_args([
            "--preset", preset, "--dataset", "synthetic", "--ckpt", ckpt, "--task", task,
            "--sampler_steps", str(RESTORE_STEPS), "--batch_size", "8", "--n_iter", "1",
            "--metrics", "--device", "cuda", "--outdir", os.path.join(tmp, f"restore_{task}")]))
        got = counts()
        calls = make_ddim_schedule(GaussianDiffusion.create(timesteps=1000).schedule,
                                   RESTORE_STEPS, 0.85).num_steps
        assert got == unet_expected(rcfg, full=2 * calls), (preset, task, got)
        assert res["range_err"] <= TOL_DDNM_RANGE and np.isfinite(res["restored"]).all(), res
        # kernels against the all-plain model: one start, the same draws
        model = randomize_parameters(build_denoiser(rcfg), 20).cuda().eval()
        gt = torch.as_tensor(res["gt"], device="cuda")
        op = (INV.sr_operator(4) if task == "sr4" else INV.gray_operator(3)
              if task == "colorize" else
              INV.inpaint_operator((torch.rand(8, 64, 64, 1, generator=hgen, device="cuda")
                                    > 0.3).float()))
        yobs = op.forward(gt)
        fn = lambda xx, tt, c, yy: model(xx, tt, cond=c, y=yy)
        run = lambda: INV.ddnm_sample(
            GaussianDiffusion.create(timesteps=1000, image_size=64), fn, yobs, op,
            num_steps=RESTORE_STEPS, generator=torch.Generator(device="cuda").manual_seed(21)).x
        with torch.inference_mode():
            x_k = run()
            model.set_impl(attn="plain", norm="plain")
            x_p = run()
        rel = rel_l2(x_k, x_p)
        assert rel <= TOL_SOLVER_REL, (preset, task, rel)
        img_s = 8 / (res["sample_seconds"] / 2)
        print(f"5h cli.restore {preset} {task} DDNM-{RESTORE_STEPS} eta 0.85 b8: "
              f"||A(x) - y|| / ||y|| {res['range_err']:.3e} (limit {TOL_DDNM_RANGE}); ssim "
              f"{res['ssim']:.4f} (naive {res['ssim_naive']:.4f}); {img_s:.4f} img/s (mean of "
              f"two batches); kernels vs all-plain rel L2 {rel:.3e} (limit {TOL_SOLVER_REL}); "
              f"launches { {k: v for k, v in got.items() if v} }; {card}", flush=True)
        out["restore"][f"{preset}_{task}"] = {"launches": got, "range_err": res["range_err"],
                                              "rel_l2": rel, "img_s": img_s}
        del model
    torch.cuda.empty_cache()
    return out


def wide_cases(gen, ugen):
    """Phase 3's rows of the wide kernels (head dims above the bodies'),
    through the separate-tensor entries: inria64's middle attention (one
    head of D 1024) at T 64 (cli.restore's b8 forward, the short training's
    b16 backward), a ragged float32 case, then T 1024 and T 4096 (256 and
    512 px: B8 forwards, a B4 backward) drawn from a generator of their own,
    so the draws of the checks before them stay. Each row times the first
    wide body beside the kernel where that body takes the shape (T up to
    1024). Returns (forward rows, backward rows)."""
    reset_counts()
    fwd = [flash_case(8, 64, 1, 1024, torch.bfloat16, "legacy", gen, tag="wide_fwd"),
           flash_case(2, 130, 2, 136, torch.float32, "contiguous", gen, tag="wide_fwd")]
    bwd = [flash_bwd_case(DIT_TRAIN_BATCH, 64, 1, 1024, torch.bfloat16, "legacy", gen, ugen,
                          hchunk=1, tag="wide_bwd"),
           flash_bwd_case(2, 130, 2, 136, torch.float32, "new", gen, ugen, hchunk=2,
                          tag="wide_bwd")]
    wgen = torch.Generator(device="cuda").manual_seed(18)
    fwd += [flash_case(8, t, 1, 1024, torch.bfloat16, "legacy", wgen, tag="wide_fwd")
            for t in (1024, 4096)]
    bwd.append(flash_bwd_case(WIDE_BATCH, 4096, 1, 1024, torch.bfloat16, "legacy", wgen, wgen,
                              hchunk=1, tag="wide_bwd"))
    got = counts()
    assert got["wide_fwd"] and got["wide_bwd"], got  # not another body
    assert not (got["flash_fwd"] or got["flash_bwd"]), got
    return fwd, bwd


def wide_forward_check(model, cfg, batch, gen, label):
    """One UNet forward at cfg.image_size px: the kernels against the
    all-plain model (plain attention, norms and convs), same weights, the
    forward's launches as UNET_ATTN gives them. Returns the rel L2."""
    size = cfg.image_size
    x = torch.randn(batch, size, size, cfg.in_channels, generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
    with torch.inference_mode():
        reset_counts()
        out_k = model.set_impl(attn="auto", norm="auto")(x, ts).float()
        launched = counts()
        out_p = model.set_impl(attn="plain", norm="plain")(x, ts).float()
        model.set_impl(attn="auto", norm="auto")
    rel = rel_l2(out_k, out_p)
    assert launched == unet_expected(cfg, full=1), (label, launched)
    assert bool(torch.isfinite(out_k).all()) and rel <= TOL_UNET_REL, (label, rel)
    return rel


def wide_grad_check(model, cfg, batch, gen, label):
    """One loss and backward at cfg.image_size px, the kernels against the
    all-plain model (attention, norms and convs): rel L2 over every
    parameter gradient, the step's launches as unet_train_expected gives
    them. A UNet with more input than output channels takes the rest as a
    concatenated condition (a cloudy view), drawn after the rest. Returns
    the rel L2."""
    size = cfg.image_size
    cc = cfg.in_channels - cfg.out_channels
    diffusion = GaussianDiffusion.create(timesteps=1000, image_size=size,
                                         **({"cond_type": "concat"} if cc else {}))
    x0 = torch.randn(batch, size, size, cfg.out_channels, generator=gen, device="cuda")
    noise = torch.randn(batch, size, size, cfg.out_channels, generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
    cond = (torch.randn(batch, size, size, cc, generator=gen, device="cuda").clamp(-1, 1)
            if cc else None)
    model_fn = lambda x, t, c, y: model(x, t, cond=c)
    grads, launched = {}, None
    for impl in ("auto", "plain"):
        model.set_impl(attn=impl, norm=impl, conv=impl).zero_grad(set_to_none=True)
        reset_counts()
        diffusion.train_loss(model_fn, x0, t=ts, noise=noise, cond=cond).backward()
        torch.cuda.synchronize()
        if impl == "auto":
            launched = counts()
        grads[impl] = {n: q.grad.float().clone() for n, q in model.named_parameters()}
    model.set_impl(attn="auto", norm="auto", conv="auto").zero_grad(set_to_none=True)
    assert launched == unet_train_expected(cfg, size, batch, 1), (label, launched)
    for name, g in grads["auto"].items():
        assert torch.isfinite(g).all(), f"{label}: non-finite gradient of {name}"
    rel = grads_rel_l2(grads["auto"], grads["plain"])
    assert rel <= TOL_UNET_GRAD_REL, (label, rel)
    del grads
    return rel


def phase_5i(tmp, card):
    """inria64 and eurosat64 at 512 px through the entry points, where their
    middle attention (one head of D 1024 / 512) sees T 4096: cli.inference
    DDIM-WIDE_STEPS at b4 for both, cli.restore inpaint at b4 and cli.train
    WIDE_TRAIN_STEPS steps at b4 for inria64, the wide kernels' launches
    asserted (one forward a UNet forward, one backward a step). Each path is
    held against the all-plain model from the same seeded weights: a UNet
    forward (TOL_UNET_REL) and a DDIM or DDNM trajectory from one start
    (TOL_SOLVER_REL), and a training loss's gradients (TOL_UNET_GRAD_REL).
    Draws from a generator of its own."""
    from eo_diffusion_torch.cli import restore as cli_restore
    from eo_diffusion_torch.diffusion import inverse as INV

    igen = torch.Generator(device="cuda").manual_seed(19)
    size, batch, steps = 512, WIDE_BATCH, WIDE_STEPS
    proc = GaussianDiffusion.create(timesteps=1000, image_size=size)
    ddim_calls = make_ddim_schedule(proc.schedule, steps, 0.0).num_steps
    ddnm_calls = make_ddim_schedule(proc.schedule, steps, 0.85).num_steps
    out = {}
    for preset in ("inria64", "eurosat64"):
        cfg = get_preset(preset).model_config()
        cfg512 = dataclasses.replace(cfg, image_size=size)
        res = run_cli(["--preset", preset, "--image_size", str(size), "--dataset", "synthetic",
                       "--sampler", "ddim", "--sampler_steps", str(steps), "--batch_size",
                       str(batch), "--n_iter", "0", "--device", "cuda"], cfg, seed=22, tmp=tmp)
        assert res["samples"].shape == (batch, size, size, 3), res["samples"].shape
        want = unet_expected(cfg512, full=ddim_calls * res["batches"])
        assert res["launches"] == want, (preset, res["launches"], want)
        img_s = res["images"] / res["sample_seconds"]
        # the same weights against the all-plain model: a forward, then DDIM
        model = randomize_parameters(build_denoiser(cfg), 22).cuda().eval()
        fwd_rel = wide_forward_check(model, cfg512, batch, igen, preset)
        x_T = torch.randn(batch, size, size, 3, generator=igen, device="cuda")
        fn = lambda xx, tt, c, yy: model(xx, tt, cond=c, y=yy)
        with torch.inference_mode():
            x_k = proc.ddim_sample(fn, batch, device="cuda", num_steps=steps, x_T=x_T).x
            model.set_impl(attn="plain", norm="plain")
            x_p = proc.ddim_sample(fn, batch, device="cuda", num_steps=steps, x_T=x_T).x
            model.set_impl(attn="auto", norm="auto")
        ddim_rel = rel_l2(x_k, x_p)
        assert torch.isfinite(x_k).all() and ddim_rel <= TOL_SOLVER_REL, (preset, ddim_rel)
        print(f"5i cli.inference {preset} --image_size {size} DDIM-{steps} b{batch}: "
              f"{img_s:.4f} img/s ({res['sample_seconds']:.3f} s), launches "
              f"{ {k: v for k, v in res['launches'].items() if v} }; kernels vs all-plain: "
              f"forward rel L2 {fwd_rel:.3e} (limit {TOL_UNET_REL}), DDIM-{steps} final "
              f"samples {ddim_rel:.3e} (limit {TOL_SOLVER_REL}); peak memory "
              f"{res['peak_mem_gb']:.2f} GiB; {card}", flush=True)
        out[f"{preset}_ddim"] = {"launches": res["launches"], "img_s": img_s,
                                 "forward_rel_l2": fwd_rel, "ddim_rel_l2": ddim_rel}
        if preset == "eurosat64":
            del model
            torch.cuda.empty_cache()
            continue

        # inpainting through cli.restore, then DDNM against the all-plain model
        ckpt = os.path.join(tmp, f"weights_{cfg.__class__.__name__}_{hash(cfg)}_22.pt")
        reset_counts()
        res = cli_restore.main(cli_restore.parse_args([
            "--preset", preset, "--image_size", str(size), "--dataset", "synthetic", "--ckpt",
            ckpt, "--task", "inpaint", "--sampler_steps", str(steps), "--batch_size",
            str(batch), "--n_iter", "0", "--device", "cuda", "--outdir",
            os.path.join(tmp, "restore_512")]))
        got = counts()
        assert got == unet_expected(cfg512, full=ddnm_calls * res["batches"]), got
        assert res["range_err"] <= TOL_DDNM_RANGE and np.isfinite(res["restored"]).all(), res
        gt = torch.as_tensor(res["gt"], device="cuda")
        op = INV.inpaint_operator((torch.rand(batch, size, size, 1, generator=igen,
                                              device="cuda") > 0.3).float())
        yobs = op.forward(gt)
        run = lambda: INV.ddnm_sample(
            proc, fn, yobs, op, num_steps=steps,
            generator=torch.Generator(device="cuda").manual_seed(21)).x
        with torch.inference_mode():
            x_k = run()
            model.set_impl(attn="plain", norm="plain")
            x_p = run()
            model.set_impl(attn="auto", norm="auto")
        ddnm_rel = rel_l2(x_k, x_p)
        assert ddnm_rel <= TOL_SOLVER_REL, ddnm_rel
        restore_img_s = res["images"] / res["sample_seconds"]
        print(f"5i cli.restore {preset} --image_size {size} inpaint DDNM-{steps} b{batch}: "
              f"||A(x) - y|| / ||y|| {res['range_err']:.3e}; {restore_img_s:.4f} img/s; "
              f"kernels vs all-plain rel L2 {ddnm_rel:.3e} (limit {TOL_SOLVER_REL}); launches "
              f"{ {k: v for k, v in got.items() if v} }; {card}", flush=True)
        out[f"{preset}_restore"] = {"launches": got, "img_s": restore_img_s,
                                    "ddnm_rel_l2": ddnm_rel, "range_err": res["range_err"]}

        # training: the gradients against the all-plain model, then the CLI
        grad_rel = wide_grad_check(model.train(), cfg512, WIDE_GRAD_BATCH, igen, preset)
        del model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with contextlib.chdir(tmp):
            r = cli_train.main(cli_train.parse_args(
                train_argv(preset, batch, WIDE_TRAIN_STEPS, 23, "train_inria64_512")
                + ["--image_size", str(size)]))
        got = counts()
        want = unet_train_expected(cfg, size, batch, WIDE_TRAIN_STEPS)
        assert r["steps"] == WIDE_TRAIN_STEPS and all(math.isfinite(x) for x in r["losses"]), r
        assert got == want, (got, want)
        sps = steady_sps(r)
        print(f"5i cli.train {preset} --image_size {size} b{batch} bf16: {r['steps']} steps, "
              f"loss {r['losses'][0]:.5f} -> {r['losses'][-1]:.5f}; {sps:.4f} steps/s over "
              f"the last {WIDE_TRAIN_STEPS - 2}; gradients vs all-plain (b{WIDE_GRAD_BATCH}) "
              f"rel L2 {grad_rel:.3e} (limit {TOL_UNET_GRAD_REL}); launches "
              f"{ {k: v for k, v in got.items() if v} }; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}", flush=True)
        out[f"{preset}_train"] = {"launches": got, "sps": sps, "grad_rel_l2": grad_rel,
                                  "losses": r["losses"]}
        del r
        torch.cuda.empty_cache()
    return out


def f32_cases():
    """The float32 kernel's rows at ``--no_bf16``'s 256 px shapes (B8 T4096 H8
    D48 at ds 4, B8 T1024 H8 D64 at ds 8), as training runs them (forward
    with the lse, backward), each beside the FMA kernel it replaced, plain and
    SDPA; drawn from a generator of their own. Returns (forward rows,
    backward rows)."""
    fgen = torch.Generator(device="cuda").manual_seed(20)
    f32 = torch.float32
    fwd = [attention_case(8, t, 8, d, f32, False, fgen, with_lse=True)
           for t, d in ((4096, 48), (1024, 64))]
    torch.cuda.empty_cache()
    bwd = [attention_bwd_case(8, t, 8, d, f32, False, fgen, fgen) for t, d in ((4096, 48),
                                                                               (1024, 64))]
    torch.cuda.empty_cache()
    return fwd, bwd


def phase_5j(tmp, card):
    """``--no_bf16`` at 256 px: ``sen12mscr256`` at full width and depth,
    batch 8, float32 end to end (TF32 off), through ``cli.inference``
    DDIM-F32_STEPS and ``cli.train`` F32_TRAIN_STEPS steps. Every attention
    launch is the float32 tensor-core kernel's (11 forward a UNet forward, 11
    backward a step) and none the FMA kernels'. Each path is held against the
    all-plain float32 model from the same seeded weights: a forward
    (TOL_UNET_REL), the DDIM trajectory from one start and cloudy view
    (TOL_SOLVER_REL), a loss's gradients at batch F32_GRAD_BATCH
    (TOL_UNET_GRAD_REL). Also the device's ms a forward and a loss and
    backward at b8 (CUDA events; single readings). Draws from a generator
    of its own."""
    jgen = torch.Generator(device="cuda").manual_seed(21)
    size, batch, steps = 256, 8, F32_STEPS
    cfg = get_preset("sen12mscr256").unet_config(bf16=False, cond_channels=3)
    assert cfg.dtype == torch.float32
    proc = GaussianDiffusion.create(timesteps=1000, image_size=size, cond_type="concat")
    calls = make_ddim_schedule(proc.schedule, steps, 0.0).num_steps
    res = run_cli(["--preset", "sen12mscr256", "--dataset", "synthetic", "--sampler", "ddim",
                   "--sampler_steps", str(steps), "--batch_size", str(batch), "--n_iter", "1",
                   "--no_bf16", "--device", "cuda"], cfg, seed=24, tmp=tmp)
    assert res["samples"].shape == (batch, size, size, 3), res["samples"].shape
    want = unet_expected(cfg, full=calls * res["batches"])
    assert res["launches"] == want and want["attn_fwd_f32"] == 11 * calls * res["batches"], (
        res["launches"], want)
    img_s = batch / res["batch_seconds"][1]
    out = {"sample": {"launches": res["launches"], "img_s": img_s,
                      "batch_seconds": res["batch_seconds"]}}

    # the same weights against the all-plain float32 model
    model = randomize_parameters(build_denoiser(cfg), 24).cuda().eval()
    cond = torch.randn(batch, size, size, 3, generator=jgen, device="cuda").clamp(-1, 1)
    x = torch.randn(batch, size, size, 3, generator=jgen, device="cuda")
    ts = torch.randint(0, 1000, (batch,), generator=jgen, device="cuda")
    fn = lambda xx, tt, c, yy: model(xx, tt, cond=c)
    with torch.inference_mode():
        reset_counts()
        out_k = model(x, ts, cond=cond)
        launched = counts()
        fwd_ms = cuda_ms(lambda: model(x, ts, cond=cond), 3, warmup=1)
        model.set_impl(attn="plain", norm="plain")
        out_p = model(x, ts, cond=cond)
        plain_fwd_ms = cuda_ms(lambda: model(x, ts, cond=cond), 2, warmup=0)
        x_T = torch.randn(batch, size, size, 3, generator=jgen, device="cuda")
        run = lambda: proc.ddim_sample(fn, batch, device="cuda", num_steps=steps, cond=cond,
                                       x_T=x_T).x
        x_p = run()
        model.set_impl(attn="auto", norm="auto")
        x_k = run()
    assert launched == unet_expected(cfg, full=1), launched
    fwd_rel, ddim_rel = rel_l2(out_k, out_p), rel_l2(x_k, x_p)
    assert bool(torch.isfinite(out_k).all()) and fwd_rel <= TOL_UNET_REL, fwd_rel
    assert bool(torch.isfinite(x_k).all()) and ddim_rel <= TOL_SOLVER_REL, ddim_rel
    print(f"5j cli.inference sen12mscr256 --no_bf16 DDIM-{steps} b{batch}: batch seconds "
          f"{[round(v, 4) for v in res['batch_seconds']]}, {img_s:.4f} img/s (second batch, a "
          f"single reading), launches { {k: v for k, v in res['launches'].items() if v} }; "
          f"device ms a b{batch} forward {fwd_ms:.3f} (all-plain {plain_fwd_ms:.3f}); kernels vs "
          f"all-plain float32: forward rel L2 {fwd_rel:.3e} (limit {TOL_UNET_REL}), DDIM-{steps} "
          f"final samples {ddim_rel:.3e} (limit {TOL_SOLVER_REL}); peak memory "
          f"{res['peak_mem_gb']:.2f} GiB; {card}", flush=True)
    out["sample"].update(forward_rel_l2=fwd_rel, ddim_rel_l2=ddim_rel, forward_device_ms=fwd_ms,
                         plain_forward_device_ms=plain_fwd_ms)

    # a loss and backward at b8 on the device, then the gradients against
    # all-plain at F32_GRAD_BATCH
    model.train()
    diffusion = GaussianDiffusion.create(timesteps=1000, image_size=size, cond_type="concat")
    noise = torch.randn(batch, size, size, 3, generator=jgen, device="cuda")
    loss_fn = lambda: diffusion.train_loss(fn, x, t=ts, noise=noise, cond=cond).backward()
    step_ms = cuda_ms(loss_fn, 3, warmup=1)
    model.zero_grad(set_to_none=True)
    grad_rel = wide_grad_check(model, cfg, F32_GRAD_BATCH, jgen, "sen12mscr256 --no_bf16")
    del model
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with contextlib.chdir(tmp):
        r = cli_train.main(cli_train.parse_args(
            train_argv("sen12mscr256", batch, F32_TRAIN_STEPS, 25, "train_f32") + ["--no_bf16"]))
    got = counts()
    want = unet_train_expected(cfg, size, batch, F32_TRAIN_STEPS)
    assert r["steps"] == F32_TRAIN_STEPS and all(math.isfinite(v) for v in r["losses"]), r
    assert got == want and want["attn_bwd_f32"] == 11 * F32_TRAIN_STEPS, (got, want)
    sps = steady_sps(r)
    print(f"5j cli.train sen12mscr256 --no_bf16 b{batch}: {r['steps']} steps, loss "
          f"{r['losses'][0]:.5f} -> {r['losses'][-1]:.5f}; {sps:.4f} steps/s over the last "
          f"{F32_TRAIN_STEPS - 2} (a single reading); device ms a b{batch} loss and backward "
          f"{step_ms:.3f}; gradients vs all-plain float32 (b{F32_GRAD_BATCH}) rel L2 "
          f"{grad_rel:.3e} (limit {TOL_UNET_GRAD_REL}); launches "
          f"{ {k: v for k, v in got.items() if v} }; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}", flush=True)
    out["train"] = {"launches": got, "sps": sps, "loss_backward_device_ms": step_ms,
                    "grad_rel_l2": grad_rel, "losses": r["losses"]}
    del r
    torch.cuda.empty_cache()
    return out


def f32_kernel_rows(fwd_rows, bwd_rows, f32_phase, extra_fwd=None, extra_bwd=None):
    """The kernels-line entries of the float32 kernel (attention_f32_sm90.cu):
    launches from phase 5j (cli.inference's forwards, cli.train's
    backwards), the times of ``--no_bf16``'s ds-4 row (B8 T4096 H8 D48), with
    "was" the FMA kernel on the same tensors, and every row under
    "shapes"."""
    src = "eo_diffusion_torch/ops/csrc/attention_f32_sm90.cu"

    def entry(name, rows, replaces, also, launches, old_src, extra):
        r = rows[0]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "replaces_also": also, "launches": launches,
                "max_abs_err": max(x["max_abs_err"] for x in rows), "ms": r["kernel_ms"],
                "was_ms": r["mma_body_ms"], "was_source": old_src, "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "bound_rate": "165 TFLOP/s (a third of dense TF32), 3.35 TB/s",
                "library_ms": r["library_ms"],
                "library_call": "F.scaled_dot_product_attention in float32, TF32 off",
                **(extra or {}),
                "shapes": [{k: x.get(k) for k in ("shape", "kernel_ms", "mma_body_ms",
                                                  "queued_ms", "mma_body_queued_ms",
                                                  "library_ms", "bound_ms", "plain_ms",
                                                  "max_abs_err", "unit_normal")}
                           for x in rows]}

    s, t = f32_phase["sample"]["launches"], f32_phase["train"]["launches"]
    return [
        entry("attention_f32_fwd", fwd_rows, "eo_diffusion_tpu/ops/attention.py:738",
              ["eo_diffusion_tpu/ops/attention.py:697", "eo_diffusion_tpu/ops/attention.py:271",
               "eo_diffusion_tpu/ops/attention.py:227"],
              s["attn_fwd_f32"] + s["flash_fwd_f32"],
              "eo_diffusion_torch/ops/csrc/attention_fwd.cu",
              {"launches_train": t["attn_fwd_f32"] + t["flash_fwd_f32"], **(extra_fwd or {})}),
        entry("attention_f32_bwd", bwd_rows, "eo_diffusion_tpu/ops/attention.py:502",
              ["eo_diffusion_tpu/ops/attention.py:429"], t["attn_bwd_f32"] + t["flash_bwd_f32"],
              "eo_diffusion_torch/ops/csrc/attention_bwd.cu", extra_bwd),
    ]


def wide_kernel_rows(wide_rows, wide_bwd_rows, wide512, extra_fwd=None, extra_bwd=None):
    """The kernels-line entries of the wide pair: launches from phase 5i's
    runs (inria64 at 512 px: DDIM sampling forward, training backward), the
    times of the first row (inria64's middle attention at 64 px), every row
    under "shapes", and the first wide body's time on the same tensors."""
    src = "eo_diffusion_torch/ops/csrc/attention_wide.cu"
    old_src = "eo_diffusion_torch/ops/csrc/attention_wide_resident.cu"

    def entry(name, rows, replaces, also, launches, extra):
        r = rows[0]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "replaces_also": also, "launches": launches,
                "max_abs_err": max(x["max_abs_err"] for x in rows), "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "old_body_ms": r["old_body_ms"],
                "old_body_source": old_src, **(extra or {}), "shapes": rows}

    runs = {k: v["launches"] for k, v in wide512.items()}
    by_run = lambda key: {"launches_512": {k: v[key] for k, v in runs.items()}}
    return [
        entry("wide_attention_fwd", wide_rows, "eo_diffusion_tpu/ops/attention.py:271",
              "eo_diffusion_tpu/ops/attention.py:227", runs["inria64_ddim"]["wide_fwd"],
              {**by_run("wide_fwd"), **(extra_fwd or {})}),
        entry("wide_attention_bwd", wide_bwd_rows, "eo_diffusion_tpu/ops/attention.py:569",
              "eo_diffusion_tpu/ops/attention.py:502", runs["inria64_train"]["wide_bwd"],
              {**by_run("wide_bwd"), **(extra_bwd or {})}),
    ]


def f32_only(card, sass):
    """``--only f32``: phase 5j's kernel rows and runs, then the float32
    kernel's kernels-line entries, the card line and the last line."""
    f32_rows, f32_bwd_rows = f32_cases()
    with tempfile.TemporaryDirectory() as tmp:
        f32_phase = phase_5j(tmp, card)
    fma = {"fma_launches_on_model_paths": sum(
        r["launches"][k] for r in f32_phase.values()
        for k in ("attn_fwd_mma", "flash_fwd_mma", "attn_bwd_mma", "flash_bwd_mma"))}
    kernels = f32_kernel_rows(f32_rows, f32_bwd_rows, f32_phase,
                              {**fma, "sass": sass["attention_f32_sm90"]},
                              {**fma, "ptxas": sass["attention_f32_sm90_ptxas"]})
    print(json.dumps({"kernels": kernels, "phase_5j": f32_phase}))
    print(card)
    print(json.dumps({"ok": True, "only": "f32",
                      "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}))
    return 0


def wide_only(card, sass):
    """``--only wide``: phase 3's wide rows and phase 5i, then the wide
    pair's kernels line, the card line and the last line."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    ugen = torch.Generator(device="cuda").manual_seed(1)
    wide_rows, wide_bwd_rows = wide_cases(gen, ugen)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        wide512 = phase_5i(tmp, card)
    census = {"sass": sass["attention_wide"]}
    kernels = wide_kernel_rows(wide_rows, wide_bwd_rows, wide512, census, census)
    print(json.dumps({"kernels": kernels, "phase_5i": wide512}))
    print(card)
    print(json.dumps({"ok": True, "only": "wide",
                      "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}))
    return 0


# -- phase 5k: the few-step families -------------------------------------------


def gn_jvp_case(n, hw, c, groups, act, dtype, gen, film=True):
    """GroupNormFn's forward-mode rule on the card (the kernel's forward, the
    tangent in plain PyTorch from its saved statistics) against
    ``torch.func.jvp`` of the plain GroupNorm, with tangents on x and, with
    ``film``, on the per-sample gamma and beta (MeanFlow's FiLM): primal and
    tangent each within TOL_GN of max(1, |plain|). Returns a result row."""
    x = torch.randn(n, hw, c, generator=gen, device="cuda").to(dtype)
    dx = torch.randn(n, hw, c, generator=gen, device="cuda").to(dtype)
    gamma = 1 + 0.1 * torch.randn(n, c, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(n, c, generator=gen, device="cuda")
    scale = 0.1 if film else 0.0
    dg, db = (scale * torch.randn(n, c, generator=gen, device="cuda") for _ in range(2))
    kern = lambda x, g, b: G.GroupNormFn.apply(x, g, b, groups, 1e-5, act)[0]
    plain = lambda x, g, b: G.group_norm_reference(x, g, b, groups, 1e-5, act)
    args, tans = (x, gamma, beta), (dx, dg, db)
    reset_counts()
    y, dy = torch.func.jvp(kern, args, tans)
    launched = counts()
    yp, dyp = torch.func.jvp(plain, args, tans)
    assert launched["gn_fwd"] == 1 and launched["gn_bwd"] == 0, launched
    label = f"N{n} HW{hw} C{c} G{groups} {act}{' film' if film else ''}"
    errs = {}
    for name, got, want in (("primal", y, yp), ("tangent", dy, dyp)):
        diff = (got.float() - want.float()).abs()
        errs[name] = (diff / want.float().abs().clamp(min=1.0)).max().item()
        assert math.isfinite(errs[name]) and errs[name] <= TOL_GN[dtype], (
            f"GroupNormFn jvp {name} vs plain at {label} {dtype}: {errs[name]} > "
            f"{TOL_GN[dtype]}")
    row = {"shape": label, "dtype": str(dtype).split(".")[-1],
           "max_scaled_err": errs["tangent"], "primal_max_scaled_err": errs["primal"],
           "jvp_ms": cuda_ms(lambda: torch.func.jvp(kern, args, tans), 20),
           "plain_jvp_ms": cuda_ms(lambda: torch.func.jvp(plain, args, tans), 5, warmup=1)}
    print("group_norm_jvp " + json.dumps(row), flush=True)
    return row


def conv_jvp_case(b, h, w, c, co, gen):
    """Conv3x3Fn's forward-mode rule on the card (bf16, cuDNN's conv of the
    tangent) against ``torch.func.jvp`` of the plain conv: the tangent within
    TOL_JVP_CONV of max|plain|, without parameter tangents (the MeanFlow
    path) and with them. Returns a result row."""
    bf16 = torch.bfloat16
    x, dx = (torch.randn(b, h, w, c, generator=gen, device="cuda").to(bf16) for _ in range(2))
    wt, dw = (torch.randn(co, c, 3, 3, generator=gen, device="cuda") / math.sqrt(9 * c)
              for _ in range(2))
    bias, db = (0.1 * torch.randn(co, generator=gen, device="cuda") for _ in range(2))
    plain = lambda x, w, bb: F.conv2d(x.permute(0, 3, 1, 2), w.to(bf16), bb.to(bf16), 1,
                                      1).permute(0, 2, 3, 1)
    kern = lambda x: CW.Conv3x3Fn.apply(x, wt, bias, bf16, False)
    _, dy = torch.func.jvp(kern, (x,), (dx,))
    _, dyp = torch.func.jvp(lambda x: plain(x, wt, bias), (x,), (dx,))
    _, dyf = torch.func.jvp(lambda x, w, bb: CW.Conv3x3Fn.apply(x, w, bb, bf16), (x, wt, bias),
                            (dx, dw, db))
    _, dyfp = torch.func.jvp(plain, (x, wt, bias), (dx, dw, db))
    err = lambda got, want: ((got.float() - want.float()).abs().max()
                             / want.float().abs().max()).item()
    e, ef = err(dy, dyp), err(dyf, dyfp)
    label = f"B{b} {h}x{w} C{c}->{co} bf16"
    assert e <= TOL_JVP_CONV and ef <= TOL_JVP_CONV, (
        f"Conv3x3Fn jvp vs plain at {label}: {e}, with parameter tangents {ef}")
    row = {"shape": label, "max_rel_err": e, "max_rel_err_param_tangents": ef,
           "route": CW.wgrad_route(b, h, w, c, co, bf16),
           "jvp_ms": cuda_ms(lambda: torch.func.jvp(kern, (x,), (dx,)), 20),
           "plain_jvp_ms": cuda_ms(lambda: torch.func.jvp(lambda x: plain(x, wt, bias), (x,),
                                                          (dx,)), 20)}
    print("conv3x3_jvp " + json.dumps(row), flush=True)
    return row


def few_expected(cfg, batch, forwards=0, backwards=0, dit=False):
    """The launch counts of ``forwards`` forwards (each with or without a
    gradient) and ``backwards`` backwards of ``cfg``'s backbone at
    ``batch``: a UNet's attention and GroupNorm launches
    (:func:`unet_expected`; none of attention for a MeanFlow UNet, whose
    attention is pinned to the plain version) and its routed weight
    gradients, or a DiT's K1 and K4 once a block."""
    if dit:
        return dit_expected(forwards, backwards)
    if cfg.attn_impl == "plain":
        _, norms = build_unet_plan(cfg).sites()
        per = {**{k: 0 for k in counts()}, "gn_fwd": norms}
    else:
        per = unet_expected(cfg, full=1)
    wg = wgrad_routes(cfg, cfg.image_size, batch, sites=None)
    return {**{k: v * forwards for k, v in per.items()},
            **{BWD_OF[k]: v * backwards for k, v in per.items() if k in BWD_OF and v},
            "wgrad": wg["mma"] * backwards, "wgrad_sm90": wg["sm90"] * backwards}


def loss_plain_check(models, loss_fn, label, expect, set_impl=None):
    """One distillation loss and backward through the kernels and through the
    all-plain models (``set_impl`` on every one, the same weights and draws):
    the loss within TOL_UNET_REL relative, the first model's (the
    student's) parameter gradients within TOL_UNET_GRAD_REL rel L2; the
    kernels' launches must be ``expect``. Returns the readings."""
    student = models[0]
    plain = set_impl or (lambda m, impl: m.set_impl(attn=impl, norm=impl, conv=impl)
                         if isinstance(m, UNet) else m.set_impl(attn=impl))
    res = {}
    for impl in ("auto", "plain"):
        for m in models:
            plain(m, impl)
        student.zero_grad(set_to_none=True)
        reset_counts()
        loss = loss_fn()
        loss.backward()
        torch.cuda.synchronize()
        res[impl] = (loss.item(), {n: p.grad.detach().float().clone()
                                   for n, p in student.named_parameters()
                                   if p.grad is not None}, counts())
    for m in models:
        plain(m, "auto")
    loss_rel = abs(res["auto"][0] - res["plain"][0]) / max(abs(res["plain"][0]), 1e-12)
    grad_rel = grads_rel_l2(res["auto"][1], res["plain"][1])
    launched = res["auto"][2]
    print(f"5k {label}: loss {res['auto'][0]:.6g} (all-plain {res['plain'][0]:.6g}, rel "
          f"{loss_rel:.3e}, limit {TOL_UNET_REL}); gradients rel L2 {grad_rel:.3e} (limit "
          f"{TOL_UNET_GRAD_REL}); launches {({k: v for k, v in launched.items() if v})}",
          flush=True)
    assert all(math.isfinite(v) for v in (loss_rel, grad_rel)), (loss_rel, grad_rel)
    assert loss_rel <= TOL_UNET_REL and grad_rel <= TOL_UNET_GRAD_REL, (label, loss_rel,
                                                                        grad_rel)
    assert launched == expect, (label, launched, expect)
    assert not any(res["plain"][2].values()), (label, res["plain"][2])
    return {"loss": res["auto"][0], "loss_plain": res["plain"][0], "loss_rel": loss_rel,
            "grad_rel_l2": grad_rel, "launches": launched}


def seeded(cfg, seed, train=False):
    model = randomize_parameters(build_denoiser(cfg), seed).cuda()
    return model.train() if train else model.eval().requires_grad_(False)


def save_teacher(tmp, cfg, seed, name):
    """Seeded weights as a port checkpoint (the train state's model and EMA)."""
    sd = randomize_parameters(build_denoiser(cfg), seed).state_dict()
    return save_checkpoint(os.path.join(tmp, "teachers"), {"model": sd, "model_ema": sd},
                           name=name)


def run_distill(argv, label, expect, card):
    """``cli.distill`` in process with the counters reset; its launches must be
    ``expect``. Returns the results with the launches."""
    from eo_diffusion_torch.cli import distill as cli_distill

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = cli_distill.main(cli_distill.parse_args(argv + ["--device", "cuda"]))
    res["launches"] = counts()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    steps = res["timing"].get("step_seconds") or res["timing"]["round1"]["step_seconds"]
    sps = res["timing"].get("steps_per_s") or res["timing"]["round1"]["steps_per_s"]
    print(f"5k cli.distill {label}: {len(steps)} steps, {sps:.4f} steps/s over the last "
          f"{len(steps) - 2} (single reading); launches "
          f"{({k: v for k, v in res['launches'].items() if v})}; peak memory "
          f"{res['peak_mem_gb']:.2f} GiB; {card}", flush=True)
    assert res["launches"] == expect, (label, res["launches"], expect)
    res["steps_per_s"] = sps
    return res


def few_sample(argv, cfg, tmp, label, expect_per_batch, card, ckpt=None, seed=31):
    """``cli.inference`` (two batches of FEW_SAMPLE_BATCH) from ``ckpt`` or
    seeded weights: the launches must be ``expect_per_batch`` a batch;
    img/s over the second batch."""
    res = run_cli(argv + ["--batch_size", str(FEW_SAMPLE_BATCH), "--n_iter", "1", "--device",
                          "cuda"], cfg, seed=seed, tmp=tmp, ckpt=ckpt)
    want = {k: v * res["batches"] for k, v in expect_per_batch.items()}
    assert res["launches"] == want, (label, res["launches"], want)
    img_s = FEW_SAMPLE_BATCH / res["batch_seconds"][1]
    print(f"5k cli.inference {label} b{FEW_SAMPLE_BATCH}: batch seconds "
          f"{[round(v, 4) for v in res['batch_seconds']]}, {img_s:.4f} img/s (second batch, a "
          f"single reading); launches {({k: v for k, v in res['launches'].items() if v})}; "
          f"{card}", flush=True)
    return {"img_s": img_s, "batch_seconds": res["batch_seconds"], "launches": res["launches"]}


def sample_plain_check(model, run, label, kinds=("attn", "norm")):
    """A sampler's final samples through the kernels against the all-plain
    model from one start and the same draws: rel L2 <= TOL_SOLVER_REL.
    ``kinds``: the kinds of layer the kernels run (a MeanFlow UNet's
    attention is plain already)."""
    with torch.inference_mode():
        got = run()
        model.set_impl(**{k: "plain" for k in kinds})
        want = run()
        model.set_impl(**{k: "auto" for k in kinds})
    rel = rel_l2(got, want)
    print(f"5k {label} vs all-plain: final samples rel L2 {rel:.3e} (limit {TOL_SOLVER_REL})",
          flush=True)
    assert bool(torch.isfinite(got).all()) and rel <= TOL_SOLVER_REL, (label, rel)
    return rel


def load_student(cfg, path):
    from eo_diffusion_torch.weights import load_reference_checkpoint

    model = build_denoiser(cfg)
    model.load_state_dict(load_reference_checkpoint(path, cfg), strict=True)
    return model.cuda().eval().requires_grad_(False)


def phase_5k(tmp, card):
    """The few-step families at full width (``cli.distill``, ``--sampler
    cm`` / ``pd``, MeanFlow through ``cli.train`` and ``cli.inference``),
    each step's kernels against the all-plain model; draws from a generator
    of its own."""
    from eo_diffusion_torch.cli.presets import build_process
    from eo_diffusion_torch.diffusion.consistency import ConsistencyDistillation
    from eo_diffusion_torch.diffusion.distill import cfg_model_fn
    from eo_diffusion_torch.diffusion.progressive import ProgressiveDistillation, pd_sample

    kgen = torch.Generator(device="cuda").manual_seed(32)
    bf16 = torch.bfloat16
    sites = EDM64_GN_SITES
    out = {"runs": {}, "checks": {}, "sample_checks": {}}
    # phase 3's rows: the forward-mode rules, K1 (with the lse) and K4 and K5
    # at the b128 distillation step's shapes
    out["gn_jvp_rows"] = ([gn_jvp_case(MF_BATCH, hw, c, 32, act, bf16, kgen)
                           for hw, c, act in sites]
                          + [gn_jvp_case(8, 4096, 64, 32, "silu", torch.float32, kgen)])
    out["conv_jvp_rows"] = [conv_jvp_case(MF_BATCH, 64, 64, 64, 64, kgen),
                            conv_jvp_case(MF_BATCH, 16, 16, 192, 192, kgen)]
    out["attn_rows"] = [attention_case(FEW_BATCH, 256, 4, 48, bf16, False, kgen, with_lse=True),
                        attention_case(FEW_BATCH, 64, 4, 64, bf16, False, kgen, with_lse=True)]
    out["bwd_rows"] = [attention_bwd_case(FEW_BATCH, 256, 4, 48, bf16, False, kgen, kgen),
                       attention_bwd_case(FEW_BATCH, 64, 4, 64, bf16, False, kgen, kgen)]
    out["gn_rows"] = [gn_case(FEW_BATCH, hw, c, 32, act, bf16, kgen) for hw, c, act in sites]
    out["wgrad_row"] = wgrad_case(MF_BATCH, 64, 64, 64, 64, bf16, kgen)
    torch.cuda.empty_cache()

    # ReFlow on latent256 (DiT-B/4 on the 64 x 64 x 4 latent grid, b32)
    lat = get_preset("latent256")
    dcfg = lat.model_config()
    flow = build_process(lat, lat.timesteps, lat.image_size)
    teacher = seeded(dcfg, 33, train=True)
    x1 = torch.randn(LATENT_BATCH, 64, 64, 4, generator=kgen, device="cuda")
    eps = torch.randn(LATENT_BATCH, 64, 64, 4, generator=kgen, device="cuda")
    tt = torch.rand(LATENT_BATCH, generator=kgen, device="cuda")
    fn = lambda x, t, c, y: teacher(x, t, cond=c, y=y)
    out["checks"]["reflow_latent256"] = loss_plain_check(
        [teacher], lambda: flow.train_loss(fn, x1, noise=eps, t=tt), "ReFlow loss latent256 b32",
        few_expected(dcfg, LATENT_BATCH, 1, 1, dit=True))
    del teacher
    torch.cuda.empty_cache()
    ckpt = save_teacher(tmp, dcfg, 33, "latent256")
    calls = 2 * 15 + 15 + 2 * (8 + 1 + 127)  # couplings, eval x1, two scores
    res = run_distill(["--preset", "latent256", "--method", "reflow", "--ckpt", ckpt,
                       "--pair_steps", "8", "--pair_method", "heun", "--n_pairs",
                       str(2 * LATENT_BATCH), "--steps", str(FEW_STEPS), "--eval_n", "8",
                       "--few_steps", "1", "--dir", os.path.join(tmp, "reflow")],
                      "reflow latent256 (DiT-B/4, b32, Heun-8 couplings)",
                      few_expected(dcfg, LATENT_BATCH, calls + FEW_STEPS, FEW_STEPS, dit=True),
                      card)
    out["runs"]["reflow_latent256"] = {k: res[k] for k in ("launches", "steps_per_s", "teacher",
                                                           "student", "peak_mem_gb")}
    ae_dir = os.path.join(tmp, "reflow_ae")
    acfg = lat.ae_config()
    AET.save_ae(ae_dir, acfg, randomize_parameters(ConvAutoencoder(acfg), 34), 0.5)
    out["runs"]["reflow_euler1"] = few_sample(
        ["--preset", "latent256", "--sampler", "flow", "--flow_method", "euler",
         "--sampler_steps", "1", "--ae_ckpt", ae_dir], dcfg, tmp,
        "latent256 ReFlow student, Euler-1 with the f4 decode",
        {**dit_expected(1), "gn_fwd": AE_NORMS // 2}, card, ckpt=res["checkpoint"])
    torch.cuda.empty_cache()

    # consistency and progressive distillation on synthetic64 at its b128
    syn = get_preset(FEW_PRESET)
    ucfg = syn.model_config()
    chain = build_process(syn, syn.timesteps, syn.image_size)
    x0 = torch.randn(FEW_BATCH, 64, 64, 3, generator=kgen, device="cuda").clamp(-1, 1)
    noise = torch.randn(FEW_BATCH, 64, 64, 3, generator=kgen, device="cuda")
    student, target, teacher = (seeded(ucfg, 35, train=True), seeded(ucfg, 35),
                                seeded(ucfg, 36))
    fns = [lambda x, t, c, y, m=m: m(x, t, cond=c, y=y) for m in (student, target, teacher)]
    cd = ConsistencyDistillation.create(chain)
    idx = torch.randint(0, cd.n_points - 1, (FEW_BATCH,), generator=kgen, device="cuda")
    out["checks"]["consistency"] = loss_plain_check(
        [student, target, teacher], lambda: cd.distill_loss(*fns, x0, idx=idx, noise=noise),
        f"consistency loss {FEW_PRESET} b{FEW_BATCH} (3 forwards, 1 backward)",
        few_expected(ucfg, FEW_BATCH, 3, 1))
    pdist = ProgressiveDistillation.create(chain, 2)
    k = torch.randint(0, 2, (FEW_BATCH,), generator=kgen, device="cuda")
    out["checks"]["progressive"] = loss_plain_check(
        [student, teacher], lambda: pdist.distill_loss(fns[0], fns[2], x0, k=k, noise=noise),
        f"progressive loss {FEW_PRESET} b{FEW_BATCH} (3 forwards, 1 backward)",
        few_expected(ucfg, FEW_BATCH, 3, 1))
    del student, target, teacher
    torch.cuda.empty_cache()
    ckpt = save_teacher(tmp, ucfg, 36, FEW_PRESET)
    common = ["--n_pairs", str(FEW_BATCH), "--pair_steps", str(FEW_POOL_STEPS), "--steps",
              str(FEW_STEPS), "--eval_n", str(FEW_SAMPLE_BATCH)]
    res = run_distill(["--preset", FEW_PRESET, "--method", "consistency", "--ckpt", ckpt,
                       *common, "--few_steps", "1", "2", "--dir", os.path.join(tmp, "cd")],
                      f"consistency {FEW_PRESET} (b{FEW_BATCH})",
                      few_expected(ucfg, FEW_BATCH, 2 * FEW_POOL_STEPS + 2 * 3 + 3 * FEW_STEPS,
                                   FEW_STEPS), card)
    out["runs"]["consistency"] = {k: res[k] for k in ("launches", "steps_per_s", "teacher_init",
                                                      "student", "peak_mem_gb")}
    cd_ckpt = res["checkpoint"]
    res = run_distill(["--preset", FEW_PRESET, "--method", "progressive", "--ckpt", ckpt,
                       *common, "--few_steps", "2", "--pd_base_steps", "4", "--pd_rounds", "1",
                       "--dir", os.path.join(tmp, "pd")],
                      f"progressive {FEW_PRESET} (b{FEW_BATCH}, 4 -> 2 steps)",
                      few_expected(ucfg, FEW_BATCH, 2 * FEW_POOL_STEPS + 2 * 2 + 3 * FEW_STEPS,
                                   FEW_STEPS), card)
    out["runs"]["progressive"] = {k: res[k] for k in ("launches", "steps_per_s", "teacher_init",
                                                      "round1", "peak_mem_gb")}
    pd_ckpt = res["checkpoint"]
    per_call = few_expected(ucfg, FEW_SAMPLE_BATCH, 1)
    for steps in (1, 2):
        out["runs"][f"cm{steps}"] = few_sample(
            ["--preset", FEW_PRESET, "--sampler", "cm", "--sampler_steps", str(steps)], ucfg,
            tmp, f"{FEW_PRESET} --sampler cm --sampler_steps {steps}",
            {k: v * steps for k, v in per_call.items()}, card, ckpt=cd_ckpt)
    out["runs"]["pd2"] = few_sample(
        ["--preset", FEW_PRESET, "--sampler", "pd", "--sampler_steps", "2"], ucfg, tmp,
        f"{FEW_PRESET} --sampler pd --sampler_steps 2", {k: v * 2 for k, v in per_call.items()},
        card, ckpt=pd_ckpt)
    out["runs"]["ddim50"] = few_sample(
        ["--preset", FEW_PRESET, "--sampler", "ddim", "--sampler_steps", "50"], ucfg, tmp,
        f"{FEW_PRESET} --sampler ddim --sampler_steps 50 (the teacher's)",
        {k: v * 50 for k, v in per_call.items()}, card, ckpt=ckpt)
    x_T = torch.randn(FEW_SAMPLE_BATCH, 64, 64, 3, generator=kgen, device="cuda")
    hops = torch.randn(3, FEW_SAMPLE_BATCH, 64, 64, 3, generator=kgen, device="cuda")
    model = load_student(ucfg, cd_ckpt)
    sfn = lambda x, t, c, y: model(x, t, cond=c, y=y)
    for steps in (1, 2):
        out["sample_checks"][f"cm{steps}"] = sample_plain_check(
            model, lambda: cd.sample(sfn, FEW_SAMPLE_BATCH, device="cuda", steps=steps, x_T=x_T,
                                     dtype=bf16, noise_fn=lambda j, role: hops[j]).x,
            f"cm-{steps} {FEW_PRESET}")
    model = load_student(ucfg, pd_ckpt)
    vchain = dataclasses.replace(chain, objective="v")
    out["sample_checks"]["pd2"] = sample_plain_check(
        model, lambda: pd_sample(vchain, sfn, FEW_SAMPLE_BATCH, device="cuda", steps=2, x_T=x_T,
                                 dtype=bf16).x, f"pd-2 {FEW_PRESET}")
    del model
    torch.cuda.empty_cache()

    # guidance distillation: cddpm64 (the guided eps regressed on a pool of
    # guided DDIM samples) and cflow64 (guided couplings re-fit), b64
    for preset in ("cddpm64", "cflow64"):
        p = get_preset(preset)
        gcfg = p.model_config(class_dropout_prob=p.class_dropout)
        proc = build_process(p, p.timesteps, p.image_size)
        ymix = torch.randint(0, p.num_classes, (p.batch_size,), generator=kgen, device="cuda")
        xb = torch.randn(p.batch_size, 64, 64, 3, generator=kgen, device="cuda").clamp(-1, 1)
        nb = torch.randn(p.batch_size, 64, 64, 3, generator=kgen, device="cuda")
        student, teacher = seeded(gcfg, 37, train=True), seeded(gcfg, 38)
        sfn = lambda x, t, c, y: student(x, t, cond=c, y=y)
        if p.process == "ddpm":
            guided = cfg_model_fn(lambda x, t, c, y: teacher(x, t, cond=c, y=y), 3.0,
                                  p.num_classes)
            tb = torch.randint(0, proc.timesteps, (p.batch_size,), generator=kgen, device="cuda")

            def loss_fn():
                x_t = proc.q_sample(xb, tb, nb).to(bf16)
                with torch.no_grad():
                    want = guided(x_t, tb, None, ymix)
                return ((sfn(x_t, tb, None, ymix).float() - want) ** 2).mean()

            fwd = 3
        else:
            tf = torch.rand(p.batch_size, generator=kgen, device="cuda")
            loss_fn = lambda: proc.train_loss(sfn, xb, noise=nb, t=tf, y=ymix)
            fwd = 1
        out["checks"][f"guided_{preset}"] = loss_plain_check(
            [student, teacher], loss_fn, f"guided loss {preset} b{p.batch_size}",
            few_expected(gcfg, p.batch_size, fwd, 1))
        del student, teacher
        torch.cuda.empty_cache()
        ckpt = save_teacher(tmp, gcfg, 38, preset)
        if p.process == "ddpm":  # the pool's guided DDIM doubles its batch: one call a step
            calls, extra = FEW_POOL_STEPS + 3 * FEW_STEPS, ["--pool_n", str(p.batch_size),
                                                            "--pool_steps", str(FEW_POOL_STEPS)]
        else:  # couplings, eval x1 and the teacher's score guided (two calls), the student's
            calls = 2 * 15 + 2 * 15 + 2 * (8 + 1 + 127) + (8 + 1 + 127) + FEW_STEPS
            extra = ["--n_pairs", str(p.batch_size), "--pair_steps", "8", "--eval_n",
                     str(FEW_SAMPLE_BATCH), "--few_steps", "1"]
        res = run_distill(["--preset", preset, "--method", "guided", "--ckpt", ckpt,
                           "--steps", str(FEW_STEPS), *extra,
                           "--dir", os.path.join(tmp, f"guided_{preset}")],
                          f"guided {preset} (b{p.batch_size}, w 3)",
                          few_expected(gcfg, p.batch_size, calls, FEW_STEPS), card)
        out["runs"][f"guided_{preset}"] = {k: res[k] for k in ("launches", "steps_per_s",
                                                               "teacher", "student")}

    # MeanFlow: meanflow64 and cmeanflow64 at b64 through cli.train, then
    # cli.inference at 1 and 2 steps; the training step's u, du/dt, loss and
    # gradients against the all-plain model on the same draws
    for preset in ("meanflow64", "cmeanflow64"):
        p = get_preset(preset)
        cfg_mf = p.mf_cfg_omega != 1.0
        mcfg = p.model_config(class_dropout_prob=0.1 if cfg_mf else 0.0)
        assert mcfg.dual_time and mcfg.attn_impl == "plain"
        mf = build_process(p, p.timesteps, p.image_size)
        model = seeded(mcfg, 39, train=True)
        xb = torch.randn(MF_BATCH, 64, 64, 3, generator=kgen, device="cuda").clamp(-1, 1)
        nb = torch.randn(MF_BATCH, 64, 64, 3, generator=kgen, device="cuda")
        t, r = mf._sample_tr(MF_BATCH, kgen, "cuda")
        drop = torch.rand(MF_BATCH, generator=kgen, device="cuda") < 0.5
        ym = (torch.randint(0, p.num_classes, (MF_BATCH,), generator=kgen, device="cuda")
              if p.num_classes else None)
        fn = lambda x, tt, c, y: model(x, tt, cond=c, y=y)
        z = (1 - t[:, None, None, None]) * xb + t[:, None, None, None] * nb
        jvps = {}
        for impl in ("auto", "plain"):
            model.set_impl(norm=impl, conv=impl)
            reset_counts()
            u, dudt = torch.func.jvp(lambda zz, tt, rr: fn(zz, mf.pack_time(tt, rr), None, ym),
                                     (z, t, r), (nb - xb, torch.ones_like(t), torch.zeros_like(r)))
            jvps[impl] = (u.detach().float(), dudt.detach().float(), counts())
        model.set_impl(norm="auto", conv="auto")
        u_rel, d_rel = (rel_l2(jvps["auto"][i], jvps["plain"][i]) for i in (0, 1))
        _, norms = build_unet_plan(mcfg).sites()
        assert jvps["auto"][2] == {**{k: 0 for k in counts()}, "gn_fwd": norms}, jvps["auto"][2]
        print(f"5k MeanFlow {preset} b{MF_BATCH} torch.func.jvp through the kernels vs "
              f"all-plain: u rel L2 {u_rel:.3e}, du/dt {d_rel:.3e} (limit {TOL_UNET_REL})",
              flush=True)
        assert u_rel <= TOL_UNET_REL and d_rel <= TOL_UNET_REL, (preset, u_rel, d_rel)
        check = loss_plain_check(
            [model], lambda: mf.train_loss(fn, xb, y=ym, noise=nb, t=torch.stack([t, r], -1),
                                           dropped=drop),
            f"MeanFlow loss {preset} b{MF_BATCH} (K5 forward and backward through the "
            "forward-mode rule, no attention kernel)",
            few_expected(mcfg, MF_BATCH, 2 if cfg_mf else 1, 1),
            set_impl=lambda m, impl: m.set_impl(norm=impl, conv=impl))
        check.update(u_rel_l2=u_rel, dudt_rel_l2=d_rel)
        out["checks"][f"meanflow_{preset}"] = check
        with contextlib.chdir(tmp):
            reset_counts()
            tr = cli_train.main(cli_train.parse_args(
                train_argv(preset, MF_BATCH, MF_TRAIN_STEPS, 40, f"train_{preset}")
                + ["--dataset", p.dataset]))  # cmeanflow64's labels: synthetic_hard
        got = counts()
        want = few_expected(mcfg, MF_BATCH, MF_TRAIN_STEPS * (2 if cfg_mf else 1),
                            MF_TRAIN_STEPS)
        assert tr["steps"] == MF_TRAIN_STEPS and all(math.isfinite(v) for v in tr["losses"])
        assert got == want, (preset, got, want)
        sps = steady_sps(tr)
        print(f"5k cli.train {preset} b{MF_BATCH}: {tr['steps']} steps, loss "
              f"{tr['losses'][0]:.5f} -> {tr['losses'][-1]:.5f}; {sps:.4f} steps/s over the "
              f"last {MF_TRAIN_STEPS - 2} (a single reading); launches "
              f"{({k: v for k, v in got.items() if v})}; {card}", flush=True)
        out["runs"][f"train_{preset}"] = {"launches": got, "sps": sps, "losses": tr["losses"]}
        mf_ckpt = tr["checkpoint"]
        del tr
        for steps in ((1, 2) if preset == "meanflow64" else (1,)):
            out["runs"][f"{preset}_{steps}"] = few_sample(
                ["--preset", preset, "--sampler_steps", str(steps)], mcfg, tmp,
                f"{preset} MeanFlow-{steps}",
                {**{k: 0 for k in counts()}, "gn_fwd": norms * steps}, card, ckpt=mf_ckpt)
        if preset == "meanflow64":  # from the seeded weights: no zero-initialised layer
            out["sample_checks"]["meanflow1"] = sample_plain_check(
                model.eval(), lambda: mf.sample(fn, FEW_SAMPLE_BATCH, device="cuda",
                                                num_steps=1, x_T=x_T, dtype=bf16).x,
                "MeanFlow-1 meanflow64", kinds=("norm",))
        del model
        torch.cuda.empty_cache()
    return out


def few_kernel_rows(few):
    """The kernels-line entries of phase 5k (``--only few``): K1 with the lse
    and K4 at the b128 distillation shapes, K5 both ways at N128 and the
    conv weight-gradient body at the MeanFlow step's level-0 site, with the
    launches of 5k's runs and the forward-mode rules' readings."""
    runs = few["runs"]
    total = lambda key: sum(r["launches"][key] for r in runs.values())

    def entry(name, source, replaces, row, key, extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": total(key), "max_abs_err": row["max_abs_err"],
                "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "launches_few": {k: r["launches"][key] for k, r in runs.items()}, **extra}

    wg = few["wgrad_row"]
    return [
        entry("qkv_attention_fwd", "eo_diffusion_torch/ops/csrc/attention_fwd_sm90.cu",
              "eo_diffusion_tpu/ops/attention.py:738", few["attn_rows"][0], "attn_fwd",
              {"shapes": few["attn_rows"]}),
        entry("qkv_attention_bwd", "eo_diffusion_torch/ops/csrc/attention_bwd_sm90.cu",
              "eo_diffusion_tpu/ops/attention.py:502", few["bwd_rows"][0], "attn_bwd",
              {"shapes": few["bwd_rows"]}),
        entry("group_norm_fwd", "eo_diffusion_torch/ops/csrc/group_norm_sm90.cu",
              "eo_diffusion_tpu/ops/group_norm.py:48", few["gn_rows"][0][0], "gn_fwd",
              {"shapes": [r[0] for r in few["gn_rows"]], "jvp_rule": few["gn_jvp_rows"]}),
        entry("group_norm_bwd", "eo_diffusion_torch/ops/csrc/group_norm_sm90.cu",
              "eo_diffusion_tpu/ops/group_norm.py:104", few["gn_rows"][0][1], "gn_bwd",
              {"shapes": [r[1] for r in few["gn_rows"]]}),
        {"name": "conv_wgrad_sm90", "route": "cuda",
         "source": "eo_diffusion_torch/ops/csrc/conv_wgrad_sm90.cu",
         "replaces": "tools/prototype_wgrad_kernel.py:40", "launches": total("wgrad_sm90"),
         "max_abs_err": wg["sm90_max_abs_err"], "ms": wg["sm90_ms"], "plain_ms": wg["plain_ms"],
         "bound_ms": wg["bound_ms"], "bound_by": wg["bound_by"], "library_ms": wg["library_ms"],
         "library_call": "aten.convolution_backward, weight gradient only (cuDNN)",
         "launches_few": {k: r["launches"]["wgrad_sm90"] for k, r in runs.items()},
         "jvp_rule": few["conv_jvp_rows"], "shapes": [wg]},
    ]


def few_only(card):
    """``--only few``: phase 5k, then its kernels line, the card line and the
    last line."""
    with tempfile.TemporaryDirectory() as tmp:
        few = phase_5k(tmp, card)
    print(json.dumps({"kernels": few_kernel_rows(few),
                      "phase_5k": {k: few[k] for k in ("runs", "checks", "sample_checks")}}))
    print(card)
    print(json.dumps({"ok": True, "only": "few",
                      "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}))
    return 0


def attention_maxima(rows):
    """The largest errors of attention probe rows, under the names of the
    limits they are held to (TOL, TOL_ATTN_L2)."""
    rows = list(rows)
    return {"max_rms_scaled_err": max(r["max_rms_scaled_err"] for r in rows),
            "max_rel_l2_err": max(r["rel_l2_err"] for r in rows)}


def probe_kernel_rows(small, probes):
    """The ``kernels`` entries of phase 8c: each kernel's row at the tools'
    shape, its launches in the tool's run, its largest error at either shape."""
    sm, var, sweep, fused = (probes[k] for k in ("softmax", "variants", "sweep", "fused"))
    by_tile = lambda res, v, tile: next(r for r in res["rows"]
                                        if r["variant"] == v and (r["warps"], r["block_k"]) == tile)
    rows = []
    for name, source, replaces, also, launches, main_row, errs, extra in (
            ("softmax_stats", "softmax_probes.cu", "tools/probe_softmax_orient.py:64", [],
             sm["launches"]["stats"], sm["stats_rows"],
             [r[k]["max_abs_err"] for r in (sm, small["softmax"]) for k in ("stats_rows",
                                                                           "stats_cols")],
             {"ms_columns": sm["stats_cols"]["kernel_ms"],
              "nearest_call": sm["stats_rows"]["nearest_call"],
              "nearest_call_ms": sm["stats_rows"]["nearest_call_ms"],
              "nearest_call_ms_columns": sm["stats_cols"]["nearest_call_ms"]}),
            ("transpose_accumulate", "softmax_probes.cu", "tools/probe_softmax_orient.py:90", [],
             sm["launches"]["transpose"], sm["transpose"],
             [r["transpose"]["max_abs_err"] for r in (sm, small["softmax"])],
             {"nearest_call": sm["transpose"]["nearest_call"],
              "nearest_call_ms": sm["transpose"]["nearest_call_ms"]}),
            ("attention_hybrid", "attn_probes.cu", "tools/probe_softmax_orient.py:117",
             ["tools/probe_softmax_orient.py:205"], sm["launches"]["hybrid"], sm["hybrid"],
             [r[k]["max_abs_err"] for r in (sm, small["softmax"]) for k in r
              if k.startswith("hybrid")],
             {**attention_maxima(r[k] for r in (sm, small["softmax"]) for k in r
                                 if k.startswith("hybrid")),
              "ms_hybrid2": sm["hybrid2"]["kernel_ms"],
              "ms_by_block_k": {k: sm[k]["kernel_ms"] for k in sm if k.startswith("hybrid")},
              "transposed_epilogue_ms": sm["hybrid"]["transposed_epilogue_ms"]}),
            ("attention_variant", "attn_variants.cu", "tools/profile_attn_variants.py:38",
             ["tools/profile_attn_variants.py:28", "tools/profile_attn_variants.py:49",
              "tools/profile_attn_variants.py:56", "tools/profile_attn_variants2.py:28"],
             var["launches"]["variant"] + sweep["launches"]["variant"],
             by_tile(var, "B", AV.K1_TILE),
             [r["max_abs_err"] for res in (var, sweep, small["variants"], small["sweep"])
              for r in res["rows"] if r["variant"] != "C"],
             {**attention_maxima(r for res in (var, sweep, small["variants"], small["sweep"])
                                 for r in res["rows"]),
              "ms_by_variant_and_tile": {f"{r['variant']} {r['warps']}w {r['block_k']}k":
                                         r["kernel_ms"] for res in (var, sweep)
                                         for r in res["rows"]},
              "mma_body_ms": var["mma_body_ms"]}),
            ("fused_layout_attention", "attention_fwd_sm90.cu",
             "tools/profile_attn_fusedlayout.py:28",
             [], fused["launches"]["attn_fwd"], fused,
             [fused["max_abs_err"], small["fused"]["max_abs_err"]],
             {**attention_maxima((fused, small["fused"])),
              "entry": "K1's fused-projection entry eo_qkv_attention_fwd (the wgmma/TMA "
                       "body), new head order",
              "separate_entry_views_ms": fused["separate_entry_views_ms"],
              "slice_fold_ms": fused["slice_fold_ms"]})):
        rows.append({"name": name, "route": "cuda",
                     "source": f"eo_diffusion_torch/ops/csrc/{source}", "replaces": replaces,
                     **({"replaces_also": also} if also else {}), "launches": launches,
                     "max_abs_err": max(errs), "ms": main_row["kernel_ms"],
                     "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
                     "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
                     **extra})
    return rows


_T0 = time.perf_counter()


def stamp(phase):
    """A line of the seconds since the script started, at a phase's start."""
    print(f"[{time.perf_counter() - _T0:.1f} s] phase {phase}", flush=True)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args not in ([], ["--only", "wide"], ["--only", "f32"], ["--only", "few"]):
        print(f"chip_smoke: unknown arguments {args} (none, --only wide, --only f32 or "
              "--only few)", file=sys.stderr)
        return 2
    only = args[1] if args else None
    # 1. the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    builds = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {sorted(builds)}", flush=True)
    for name, info in builds.items():
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        print(f"{name}: {len(regs)} entry points; ptxas: {regs[:4]}")
    sass = {}
    for name in ("attention_fwd_sm90", "attention_bwd_sm90"):
        sass[name] = sass_census(builds[name]["path"])
        print(f"{name} SASS: {json.dumps(sass[name])}", flush=True)
        assert sass[name]["HGMMA"] > 0 and sass[name]["UTMALDG"] > 0, sass  # wgmma, TMA
    sass["attention_wide"] = sass_census(builds["attention_wide"]["path"])
    print(f"attention_wide SASS: {json.dumps(sass['attention_wide'])}", flush=True)
    assert sass["attention_wide"]["HMMA"] > 0, sass  # its bf16 products: mma.sync
    sass["attention_f32_sm90"] = sass_census(builds["attention_f32_sm90"]["path"])
    print(f"attention_f32_sm90 SASS: {json.dumps(sass['attention_f32_sm90'])}", flush=True)
    assert sass["attention_f32_sm90"]["HMMA_TF32"] > 0, sass  # its products: TF32 mma.sync
    sass["attention_f32_sm90_ptxas"] = ptxas_report(builds["attention_f32_sm90"]["log"])
    for fn, r in sass["attention_f32_sm90_ptxas"].items():
        print(f"attention_f32_sm90 ptxas: {fn}: {r}")
        # the backward's accumulators stay in registers at D 64-128, and the
        # forward spills nothing at the paths' head dims (48, 64)
        dp = re.search(r"attn_(fwd|bwd)_tf32ILi(\d+)ELi3E", fn)
        if dp and (dp.group(1) == "bwd" and int(dp.group(2)) >= 64
                   or dp.group(1) == "fwd" and int(dp.group(2)) in (48, 64)):
            assert r["spill_stores"] == 0 == r["spill_loads"], (fn, r)
    if only == "wide":
        return wide_only(card, sass)
    if only == "f32":
        return f32_only(card, sass)
    if only == "few":
        return few_only(card)

    stamp("3")
    # 3. kernel vs plain at the path's shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for new_order in (False, True):  # main path: clouds UNet at 256 px, batch 8
        rows.append(attention_case(8, 4096, 8, 48, torch.bfloat16, new_order, gen))
        rows.append(attention_case(8, 1024, 8, 64, torch.bfloat16, new_order, gen))
    rows.append(attention_case(8, 256, 8, 48, torch.bfloat16, False, gen))  # 64 px, ds 4
    rows.append(attention_case(8, 64, 8, 64, torch.bfloat16, False, gen))   # 64 px, ds 8
    rows.append(attention_case(2, 1024, 8, 64, torch.float32, False, gen))  # --no_bf16
    rows.append(attention_case(8, 4096, 8, 64, torch.bfloat16, False, gen))  # 512 px, ds 8
    rows.append(attention_case(3, 1000, 4, 48, torch.bfloat16, True, gen))   # ragged T
    # the DiT's shapes, new head order: dit256 (DiT-B/8), the probe's DiT-B/4
    # at the latent256 grid, dit64 (DiT-S/4)
    dit_rows = [attention_case(8, 1024, 12, 64, torch.bfloat16, True, gen),
                attention_case(32, 256, 12, 64, torch.bfloat16, True, gen),
                attention_case(8, 256, 6, 64, torch.bfloat16, True, gen)]
    rows += dit_rows
    # the W8A8 attention probe kernel: the probe's shape, and a smaller f32 one
    int8_rows = [int8_case(32, 12, 256, 64, torch.bfloat16, gen),
                 int8_case(2, 4, 128, 32, torch.float32, gen)]
    # the forward as training runs it: with the lse, at the two main shapes
    lse_rows = [attention_case(8, 4096, 8, 48, torch.bfloat16, False, gen, with_lse=True),
                attention_case(8, 1024, 8, 64, torch.bfloat16, False, gen, with_lse=True)]
    rows += lse_rows
    # the forward as a dit256 training step runs it: b16, new head order, lse.
    # The DiT training checks (here, the backward's row, phase 4d) draw from
    # a generator of their own, so every other check keeps its draws
    dgen = torch.Generator(device="cuda").manual_seed(13)
    dit_lse_row = attention_case(16, 1024, 12, 64, torch.bfloat16, True, dgen, with_lse=True)
    rows.append(dit_lse_row)

    # the unit-normal checks of the backward draw apart, so the draws of the
    # checks at doubled q and k stay those of the runs before them
    ugen = torch.Generator(device="cuda").manual_seed(1)
    bwd_rows = []
    bf16, f32 = torch.bfloat16, torch.float32
    for new_order in (False, True):  # training path: clouds UNet at 256 px, batch 8
        bwd_rows.append(attention_bwd_case(8, 4096, 8, 48, bf16, new_order, gen, ugen))
    bwd_rows.append(attention_bwd_case(8, 1024, 8, 64, bf16, False, gen, ugen))
    bwd_rows.append(attention_bwd_case(8, 256, 8, 48, bf16, False, gen, ugen))  # 64 px
    bwd_rows.append(attention_bwd_case(8, 64, 8, 64, bf16, False, gen, ugen))   # 64 px
    bwd_rows.append(attention_bwd_case(2, 1024, 8, 64, f32, False, gen, ugen))  # --no_bf16
    bwd_rows.append(attention_bwd_case(3, 1000, 4, 48, bf16, True, gen, ugen))  # ragged T
    dit_bwd_row = attention_bwd_case(16, 1024, 12, 64, bf16, True, dgen, dgen)  # dit256 b16
    bwd_rows.append(dit_bwd_row)
    torch.cuda.empty_cache()

    # the separate-tensor entries (K2/K3's forward, K4 behind it): the clouds
    # UNet at 512 px (ds 4, T 16384) and 384 px (T 9216 and 2304), both head
    # orders of the split_qkv views and contiguous tensors, a ragged f32 case
    flash_rows = [
        flash_case(8, 16384, 8, 48, torch.bfloat16, "legacy", gen, chunk=1),
        flash_case(1, 16384, 8, 48, torch.bfloat16, "new", gen),
        flash_case(8, 9216, 8, 48, torch.bfloat16, "legacy", gen, chunk=2),
        flash_case(2, 9216, 8, 48, torch.bfloat16, "new", gen),
        flash_case(8, 2304, 8, 64, torch.bfloat16, "legacy", gen),
        flash_case(8, 2304, 8, 64, torch.bfloat16, "new", gen),
        flash_case(8, 2304, 8, 64, torch.bfloat16, "contiguous", gen),
        flash_case(2, 2309, 4, 48, torch.float32, "legacy", gen),
        flash_case(2, 2309, 4, 48, torch.bfloat16, "new", gen),        # ragged T
        # head dims above 128, which only the wgmma/TMA body takes
        flash_case(2, 2309, 4, 160, torch.bfloat16, "legacy", gen),
        flash_case(2, 2309, 4, 256, torch.bfloat16, "new", gen),
    ]
    torch.cuda.empty_cache()
    flash_bwd_rows = [
        flash_bwd_case(4, 16384, 8, 48, torch.bfloat16, "legacy", gen, ugen, hchunk=2),  # 512 px b4
        flash_bwd_case(1, 16384, 2, 48, torch.bfloat16, "new", gen, ugen, hchunk=2),
        flash_bwd_case(4, 2304, 8, 64, torch.bfloat16, "legacy", gen, ugen, hchunk=8),  # 384 px
        flash_bwd_case(2, 2309, 4, 48, torch.float32, "contiguous", gen, ugen, hchunk=4),
        # head dims above 128, which only the wgmma/TMA backward takes
        flash_bwd_case(2, 2309, 4, 160, torch.bfloat16, "legacy", ugen, ugen, hchunk=4),
        flash_bwd_case(2, 2309, 4, 256, torch.bfloat16, "new", ugen, ugen, hchunk=4),
    ]
    torch.cuda.empty_cache()
    wide_rows, wide_bwd_rows = wide_cases(gen, ugen)
    torch.cuda.empty_cache()

    # GroupNorm + FiLM + SiLU, forward and backward: the clouds UNet's norm
    # sites at 256 px, batch 8 (levels 0-3; the attention norm has no SiLU;
    # 896 channels are groups of 28), then FiLM, a narrow width, f32 and the
    # mean-100 case where E[x^2] - E[x]^2 in f32 cancels
    gn_rows = []
    for n, hw, c, groups, act, dtype, film, loc, fault in (
            (8, 65536, 128, 32, "silu", torch.bfloat16, False, 0.0, True),
            (8, 16384, 256, 32, "silu", torch.bfloat16, False, 0.0, False),
            (8, 4096, 384, 32, "none", torch.bfloat16, False, 0.0, True),
            (8, 1024, 512, 32, "silu", torch.bfloat16, False, 0.0, True),
            (8, 4096, 896, 32, "silu", torch.bfloat16, False, 0.0, False),
            (8, 4096, 384, 32, "silu", torch.bfloat16, True, 0.0, False),
            (8, 4096, 24, 24, "silu", torch.bfloat16, False, 0.0, False),
            (2, 16384, 256, 32, "silu", torch.float32, False, 0.0, False),
            (2, 65536, 128, 32, "silu", torch.float32, False, 100.0, False),
            (8, 262144, 128, 32, "silu", torch.bfloat16, False, 0.0, False)):  # 512 px, level 0
        gn_rows.append(gn_case(n, hw, c, groups, act, dtype, gen, film=film, loc=loc,
                               fault=fault))
    torch.cuda.empty_cache()

    # latent256-cr at batch 32: K1 with the lse and K4 as a DiT-B/4 training
    # step runs them (T 256, D 64, 12 heads, new order), and the GroupNorm +
    # SiLU kernels in float32 at the first stage's three site shapes; then
    # the shapes phase 7f's sampling gives them at batch 8 (K1 without the
    # lse; the first stage's forward, whose plans may differ with N). These
    # draw from a generator of their own (lgen), as phases 4e and 5e do, so
    # every earlier check keeps its draws
    lgen = torch.Generator(device="cuda").manual_seed(14)
    latent_lse_row = attention_case(LATENT_BATCH, 256, 12, 64, torch.bfloat16, True, lgen,
                                    with_lse=True)
    rows.append(latent_lse_row)
    latent_bwd_row = attention_bwd_case(LATENT_BATCH, 256, 12, 64, bf16, True, lgen, lgen)
    bwd_rows.append(latent_bwd_row)
    rows.append(attention_case(LATENT_SAMPLE_BATCH, 256, 12, 64, torch.bfloat16, True, lgen))
    ae_gn_rows = [gn_case(n, hw, c, 32, "silu", torch.float32, lgen, library_silu=True)
                  for n in (LATENT_BATCH, LATENT_SAMPLE_BATCH) for hw, c in AE_GN_SITES]
    gn_rows += ae_gn_rows
    torch.cuda.empty_cache()

    # classifier-free guidance doubles phase 5f's 256 px batch: K1 at B16 at
    # the clouds UNet's two attention shapes and K5 at N16 at its level
    # shapes, drawn from a generator of their own (cgen), as 5f's are
    cgen = torch.Generator(device="cuda").manual_seed(15)
    cfg_rows = [attention_case(16, 4096, 8, 48, torch.bfloat16, False, cgen),
                attention_case(16, 1024, 8, 64, torch.bfloat16, False, cgen)]
    rows += cfg_rows
    cfg_gn_rows = [gn_case(16, hw, c, 32, act, torch.bfloat16, cgen)
                   for hw, c, act in CFG_GN_SITES]
    gn_rows += cfg_gn_rows
    torch.cuda.empty_cache()

    stamp("4")
    # 4. UNet forward and backward at 256 px, batch 2, and (4b) at 384 px,
    # batch 1: the kernels against the all-plain model (plain attention and
    # plain norms), same weights. At 384 px every attention takes the
    # separate-tensor route, and the plain model's saved softmaxes still fit
    # (about 2.7 GB a block at ds 4); the 512 px all-plain backward would not
    for size, batch in ((256, 2), (384, 1)):
        model = unet_forward_check(size, batch, gen)
        unet_backward_check(model.train(), size, batch, gen)
        del model
        torch.cuda.empty_cache()

    stamp("4c")
    # 4c. the DiT: a DiT-B/8 forward at 256 px, batch 8, and the probe's
    # DiT-B/4 call at the latent256 shape (4 channels, 64 x 64), batch 32
    dit_fwd = {
        "dit256": dit_forward_check(dit_b(256, dtype=torch.bfloat16), 8, gen, "DiT-B/8 256 px"),
        "dit_b4_latent256": dit_forward_check(
            DiTConfig(image_size=64, in_channels=4, out_channels=4, patch_size=4,
                      hidden_size=768, depth=DIT_DEPTH, num_heads=12, dtype=torch.bfloat16),
            32, gen, "DiT-B/4 latent256"),
    }
    torch.cuda.empty_cache()

    stamp("4d")
    # 4d. a dit256 (DiT-B/8) flow-matching loss and backward at 256 px, batch
    # 16: K1 with the lse and K4 in the new head order inside a model
    cfg = dit_b(256, dtype=torch.bfloat16)
    model = randomize_parameters(DiT(cfg), seed=1).cuda()
    x0 = torch.randn(DIT_TRAIN_BATCH, 256, 256, cfg.in_channels, generator=dgen, device="cuda")
    dit_grad = dit_train_check(model, FlowMatching.create(image_size=256, in_channels=3), x0,
                               dgen, "DiT-B/8 256 px")
    del model, x0
    torch.cuda.empty_cache()

    stamp("4e")
    # 4e. latent256-cr: the f32 first stage and a DiT-B/4 flow step on its
    # latents, batch 32, kernels against the all-plain models
    latent_grad = latent_train_check(lgen)

    with tempfile.TemporaryDirectory() as tmp:
        stamp("5")
        # 5. the main path through the entry point
        steps = 50
        sen = get_preset("sen12mscr256")
        main_res = run_cli(["--preset", "sen12mscr256", "--dataset", "synthetic",
                            "--sampler", "ddim", "--sampler_steps", str(steps),
                            "--batch_size", "8", "--n_iter", "0", "--device", "cuda"],
                           sen.unet_config(cond_channels=3), seed=2, tmp=tmp)
        assert main_res["samples"].shape == (8, 256, 256, 3), main_res["samples"].shape
        want = expected(256, steps * main_res["batches"])
        assert main_res["launches"] == want, (main_res["launches"], want)
        print(f"main path sen12mscr256 DDIM-{steps} b8: {main_res['images']} images in "
              f"{main_res['sample_seconds']:.3f} s = "
              f"{main_res['images'] / main_res['sample_seconds']:.4f} img/s, "
              f"kernel launches {main_res['launches']}, peak memory "
              f"{main_res['peak_mem_gb']:.2f} GiB", flush=True)

        stamp("5b")
        # 5b. the same entry point at 512 px: whole scenes, ds 4 at T 16384
        res512 = run_cli(["--preset", "sen12mscr256", "--image_size", "512", "--dataset",
                          "synthetic", "--sampler", "ddim", "--sampler_steps", str(STEPS_512),
                          "--batch_size", "8", "--n_iter", "0", "--device", "cuda"],
                         sen.unet_config(cond_channels=3), seed=2, tmp=tmp)
        assert res512["samples"].shape == (8, 512, 512, 3), res512["samples"].shape
        want = expected(512, STEPS_512 * res512["batches"])
        assert res512["launches"] == want, (res512["launches"], want)
        print(f"sen12mscr256 --image_size 512 DDIM-{STEPS_512} b8: {res512['images']} images "
              f"in {res512['sample_seconds']:.3f} s = "
              f"{res512['images'] / res512['sample_seconds']:.4f} img/s, "
              f"kernel launches {res512['launches']}, peak memory "
              f"{res512['peak_mem_gb']:.2f} GiB; {card}", flush=True)

        stamp("5c")
        # 5c. the same scenes tiled: the 256 px denoiser over 3 x 3 tiles
        tiled = run_tiled(sen.unet_config(cond_channels=3), seed=2, gen=gen, n=8,
                          steps=STEPS_512)
        print(f"tiled_ddim_sample 512x512 tile 256 overlap 0.5 DDIM-{STEPS_512} b8: "
              f"{tiled['images']} scenes in {tiled['seconds']:.3f} s = "
              f"{tiled['images'] / tiled['seconds']:.4f} img/s (whole scene "
              f"{res512['sample_seconds']:.3f} s), kernel launches {tiled['launches']}, "
              f"peak memory {tiled['peak_mem_gb']:.2f} GiB; {card}", flush=True)

        stamp("6")
        # 6. the reference's 64 px RePaint DDPM path
        t64 = 100
        res64 = run_cli(["--preset", "clouds64-attn", "--dataset", "synthetic",
                         "--sampler", "ddpm", "--timesteps", str(t64), "--batch_size", "8",
                         "--n_iter", "1", "--device", "cuda"],
                        get_preset("clouds64-attn").unet_config(), seed=3, tmp=tmp)
        assert res64["samples"].shape == (8, 64, 64, 3), res64["samples"].shape
        want64 = expected(64, t64 * res64["batches"])
        assert res64["launches"] == want64, (res64["launches"], want64)
        print(f"clouds64-attn RePaint DDPM-{t64} b8: {res64['images']} images in "
              f"{res64['sample_seconds']:.3f} s = "
              f"{res64['images'] / res64['sample_seconds']:.4f} img/s, "
              f"kernel launches {res64['launches']}", flush=True)

        stamp("5d")
        # 5d. the DiT family through the entry point: three batches of 8 each,
        # img/s over the last two (the first pays cuBLAS's first calls)
        dit_res = {}
        for i, (name, flags, calls) in enumerate(DIT_RUNS):
            argv = ["--preset", name, "--dataset", "synthetic", *flags, "--batch_size", "8",
                    "--n_iter", "2", "--device", "cuda"]
            res = run_cli(argv, get_preset(name).model_config(), seed=6 + i, tmp=tmp)
            size = get_preset(name).image_size
            assert res["samples"].shape == (8, size, size, 3), res["samples"].shape
            want = dit_expected(calls * res["batches"])
            assert res["launches"] == want, (name, flags, res["launches"], want)
            steady = res["batch_seconds"][1:]
            res["img_s"] = 8 * len(steady) / sum(steady)
            tag = f"{name} {' '.join(flags[1::2])}"
            print(f"{tag} b8: {res['batches']} batches, {calls} model calls a batch, "
                  f"{res['launches']['attn_fwd'] // res['batches']} fused-qkv launches a "
                  f"batch; batch seconds {[round(x, 4) for x in res['batch_seconds']]}; "
                  f"{res['img_s']:.4f} img/s over the last {len(steady)}; peak memory "
                  f"{res['peak_mem_gb']:.2f} GiB; {card}", flush=True)
            del res["samples"]
            dit_res[tag] = res

        stamp("5e")
        # 5e. tiled_flow_sample of 512 x 512 scenes with the dit256 denoiser
        tiled_flow = run_tiled_flow(seed=12, gen=lgen, n=TILED_FLOW_SCENES, steps=8, card=card)

        stamp("5f")
        # 5f. the sampling CLI's solvers and guidance
        guided = phase_5f(tmp, card, cgen, main_res["images"] / main_res["sample_seconds"])
        guided_runs = (*guided["runs"].values(), guided["tiled"])

        stamp("5g")
        # 5g. EDM and the Brownian bridge: training, sampling, the tiled
        # bridge and the demos
        edm_bridge = phase_5g(tmp, card)
        edm_runs = [{"launches": r[k]} for r in edm_bridge["runs"].values()
                    for k in ("train_launches", "sample_launches")]
        edm_runs += [r["plain"] for r in edm_bridge["runs"].values()]
        edm_runs += [edm_bridge["tiled"], *edm_bridge["demos"].values()]
        rows += edm_bridge["attn_rows"]
        gn_rows += edm_bridge["gn_rows"]
        stamp("5h")
        # 5h. classifier guidance and DDNM restoration
        clf_phase = phase_5h(tmp, card)
        clf_runs = [*clf_phase["runs"].values(), clf_phase["grad"], clf_phase["guided_plain"],
                    *clf_phase["restore"].values()]
        rows += clf_phase["attn_rows"]
        bwd_rows += clf_phase["bwd_rows"]
        gn_rows += clf_phase["gn_rows"]
        clf_launches = lambda key: {
            **{tag: r["launches"][key] for tag, r in clf_phase["runs"].items()},
            "input_grad_b8": clf_phase["grad"]["launches"][key],
            **{f"restore_{k}": r["launches"][key] for k, r in clf_phase["restore"].items()}}
        stamp("5i")
        # 5i. inria64 and eurosat64 at 512 px: the wide kernels at T 4096
        wide512 = phase_5i(tmp, card)
        wide_runs = list(wide512.values())
        stamp("5j")
        # 5j. --no_bf16 at 256 px: the float32 kernel's rows, then
        # sen12mscr256 in float32 through cli.inference and cli.train
        f32_rows, f32_bwd_rows = f32_cases()
        f32_phase = phase_5j(tmp, card)
        f32_runs = list(f32_phase.values())
        stamp("5k")
        # 5k. the few-step families: ReFlow, consistency, progressive and
        # guidance distillation through cli.distill, cm / pd sampling, MeanFlow
        few = phase_5k(tmp, card)
        few_runs = list(few["runs"].values())
        edm_launches = lambda key: {
            **{f"{p}_{k}": r[f"{k}_launches"][key] for p, r in edm_bridge["runs"].items()
               for k in ("train", "sample")},
            "tiled_bridge": edm_bridge["tiled"]["launches"][key],
            **{f"demo_{d}": r["launches"][key] for d, r in edm_bridge["demos"].items()}}

        stamp("7")
        # 7. the training path through the entry point
        train_res = run_train(tmp, seed=4)
        steady = train_res["step_seconds"][2:]  # after cuDNN's plan search
        sps = len(steady) / sum(steady)
        print(f"training path sen12mscr256 b8 bf16: {train_res['steps']} steps in "
              f"{train_res['seconds']:.3f} s; steady {sps:.4f} steps/s = {8 * sps:.4f} img/s; "
              f"loss {train_res['losses'][0]:.5f} -> {train_res['losses'][-1]:.5f}; "
              f"launches {train_res['launches']}; "
              f"|d params| {train_res['param_delta']:.4e} |d ema| {train_res['ema_delta']:.4e}; "
              f"peak memory {train_res['peak_mem_gb']:.2f} GiB; {card}", flush=True)

        stamp("7b")
        # 7b. the training entry point at 512 px, batch 4
        train512 = run_train_512(tmp, seed=5)
        steady = train512["step_seconds"][2:]
        sps512 = len(steady) / sum(steady)
        print(f"training path sen12mscr256 --image_size 512 b4 bf16: {train512['steps']} "
              f"steps in {train512['seconds']:.3f} s; steady {sps512:.4f} steps/s = "
              f"{4 * sps512:.4f} img/s; loss {train512['losses'][0]:.5f} -> "
              f"{train512['losses'][-1]:.5f}; launches {train512['launches']}; peak memory "
              f"{train512['peak_mem_gb']:.2f} GiB; {card}", flush=True)

        stamp("7c")
        # 7c. the SEN12MS-CR feed at full width: GeoTIFFs on disk to the card
        sen = phase_7c(tmp, card, train_res)

        stamp("7d")
        # 7d. DiT and flow training through the entry point
        dit_train = run_train_dit(tmp, seed=10, card=card)

        stamp("7e")
        # 7e. evaluation: SSIM/PSNR in the sampling CLI, cli.evaluate, the extractors
        evaluation = phase_7e(tmp, card, sen)

        stamp("7f")
        # 7f. latent256-cr through the entry points: the first stage, then
        # DiT-B/4 on its latents, then sampling and decoding from both
        latent_train = run_train_latent(tmp, seed=15, card=card)

    stamp("8")
    # 8. the W8A8 attention probe, once
    reset_counts()
    probe = probe_int8_attn.run(seed=0)
    probe_launches = counts()
    assert probe_launches["int8"] > 0, probe_launches
    print("probe_int8_attn " + json.dumps(probe), flush=True)

    stamp("8b")
    # 8b. the conv weight-gradient kernel and the attention-matmul probes
    wgrad_rows, wgrad_deltas, attn_t_rows, sweep, mm, packed = phase_8b(gen, card)

    stamp("8c")
    # 8c. the softmax-orientation probes and the attention variants
    small, probes = phase_8c(gen)

    stamp("9")
    # 9. the result lines
    latent_runs = ({"launches": latent_train["ae_launches"]},
                   {"launches": latent_train["launches"]},
                   {"launches": latent_train["sample_launches"]})
    latent_row = lambda r: {k: r[k] for k in ("shape", "kernel_ms", "library_ms",
                                              "library_silu_ms", "bound_ms", "bound_by",
                                              "plain_ms", "max_abs_err") if k in r}
    main_row = rows[0]
    bwd_row = bwd_rows[0]
    gn_fwd_rows, gn_bwd_rows = [r[0] for r in gn_rows], [r[1] for r in gn_rows]
    sm90_rows = [r for r in rows + flash_rows if r["dtype"] == "bfloat16"]
    sm90_bwd_rows = [r for r in bwd_rows + flash_bwd_rows if r["dtype"] == "bfloat16"]
    old_wide_launches = lambda key: sum(
        r["launches"][key] for r in (main_res, res512, res64, train_res, train512, tiled,
                                     tiled_flow, *dit_res.values(), *latent_runs, *guided_runs,
                                     *edm_runs, *clf_runs, *wide_runs, *f32_runs, *few_runs))
    assert not any(old_wide_launches(k) for k in ("wide_fwd_resident", "wide_bwd_resident"))
    # the FMA kernels (and the mma.sync bodies) of attention_fwd.cu and
    # attention_bwd.cu are yardsticks only: no model path launches them
    assert not any(old_wide_launches(k) for k in ("attn_fwd_mma", "flash_fwd_mma",
                                                  "attn_bwd_mma", "flash_bwd_mma"))
    kernels = [{
        "name": "attention_fwd_sm90",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_fwd_sm90.cu",
        "replaces": "eo_diffusion_tpu/ops/attention.py:738",
        "replaces_also": ["eo_diffusion_tpu/ops/attention.py:697",
                          "eo_diffusion_tpu/ops/attention.py:271",
                          "eo_diffusion_tpu/ops/attention.py:227"],
        "launches": main_res["launches"]["attn_fwd"] + main_res["launches"]["flash_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in sm90_rows),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "mma_body_ms": main_row["mma_body_ms"],
        "launches_512": res512["launches"]["attn_fwd"] + res512["launches"]["flash_fwd"],
        "launches_train_512": train512["launches"]["attn_fwd"]
        + train512["launches"]["flash_fwd"],
        "mma_body_launches_on_model_paths": sum(
            r["launches"][k] for r in (main_res, res512, res64, train_res, train512, tiled,
                                       tiled_flow, *dit_res.values(), *latent_runs,
                                       *guided_runs, *edm_runs, *clf_runs, *wide_runs,
                                       *f32_runs, *few_runs)
            for k in ("attn_fwd_mma", "flash_fwd_mma")),
        "unit_normal_max": attention_maxima(r["unit_normal"] for r in sm90_rows
                                            if r["unit_normal"]),
        "launches_edm_bridge": edm_launches("attn_fwd"),
        "sass": sass["attention_fwd_sm90"],
        "shapes": [{k: r[k] for k in ("shape", "kernel_ms", "mma_body_ms", "library_ms",
                                      "bound_ms", "plain_ms", "max_abs_err")}
                   for r in sm90_rows],
    }, {
        "name": "qkv_attention_fwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_fwd_sm90.cu",
        "source_float32": "eo_diffusion_torch/ops/csrc/attention_f32_sm90.cu",
        "replaces": "eo_diffusion_tpu/ops/attention.py:738",
        "launches": main_res["launches"]["attn_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "launches_clouds64": res64["launches"]["attn_fwd"],
        "launches_train": train_res["launches"]["attn_fwd"],
        "launches_dit": {tag: r["launches"]["attn_fwd"] for tag, r in dit_res.items()},
        "ms_with_lse": lse_rows[0]["kernel_ms"],
        "ms_dit256": dit_rows[0]["kernel_ms"],
        "dit256_train": {k: dit_lse_row[k] for k in ("shape", "kernel_ms", "library_ms",
                                                     "bound_ms", "plain_ms", "max_abs_err")},
        "launches_dit256_train": dit_train["launches"]["attn_fwd"],
        "dit256_train_grad_check": dit_grad,
        "latent256_train": latent_row(latent_lse_row),
        "launches_latent256_train": latent_train["launches"]["attn_fwd"],
        "launches_latent256_sample": latent_train["sample_launches"]["attn_fwd"],
        "launches_tiled_flow": tiled_flow["launches"]["attn_fwd"],
        "cfg_b16": [latent_row(r) for r in cfg_rows],
        "launches_guidance": {tag: r["launches"]["attn_fwd"]
                              for tag, r in guided["runs"].items()},
        "launches_guidance_tiled": guided["tiled"]["launches"]["attn_fwd"],
        "pag_identity_hits": guided["runs"]["pag2-ddim10"]["identity_hits"],
        "guidance_checks": guided["plain_checks"],
        "latent256_train_check": latent_grad,
        "classifier_f32_lse": [latent_row(r) for r in clf_phase["attn_rows"]],
        "launches_classifier": clf_launches("attn_fwd"),
        "classifier_checks": {k: clf_phase[k]["rel_l2"] for k in ("grad", "guided_plain")},
        "mma_body_ms": main_row["mma_body_ms"],
        "dit_forward_rel_l2": dit_fwd,
        "shapes": rows,
    }, {
        "name": "attention_bwd_sm90",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_bwd_sm90.cu",
        "replaces": "eo_diffusion_tpu/ops/attention.py:502",
        "replaces_also": ["eo_diffusion_tpu/ops/attention.py:429"],
        "launches": train_res["launches"]["attn_bwd"] + train_res["launches"]["flash_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in sm90_bwd_rows),
        "ms": bwd_row["kernel_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "mma_body_ms": bwd_row["mma_body_ms"],
        "launches_train_512": train512["launches"]["attn_bwd"]
        + train512["launches"]["flash_bwd"],
        "launches_edm_bridge": edm_launches("attn_bwd"),
        "mma_body_launches_on_model_paths": sum(
            r["launches"][k] for r in (main_res, res512, res64, train_res, train512, tiled,
                                       tiled_flow, *dit_res.values(), *latent_runs,
                                       *guided_runs, *edm_runs, *clf_runs, *wide_runs,
                                       *f32_runs, *few_runs)
            for k in ("attn_bwd_mma", "flash_bwd_mma")),
        "unit_normal_max": {
            "max_rms_scaled_err": max(r["unit_normal"]["max_rms_scaled_err"]
                                      for r in sm90_bwd_rows),
            "max_rel_l2_err": max(r["unit_normal"]["rel_l2_err"] for r in sm90_bwd_rows)},
        "sass": sass["attention_bwd_sm90"],
        "shapes": [{k: r[k] for k in ("shape", "kernel_ms", "mma_body_ms", "library_ms",
                                      "bound_ms", "plain_ms", "max_abs_err")}
                   for r in sm90_bwd_rows],
    }, {
        "name": "qkv_attention_bwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_bwd_sm90.cu",
        "source_float32": "eo_diffusion_torch/ops/csrc/attention_f32_sm90.cu",
        "replaces": "eo_diffusion_tpu/ops/attention.py:502",
        "launches": train_res["launches"]["attn_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["dtype"] == "bfloat16"),
        "ms": bwd_row["kernel_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "mma_body_ms": bwd_row["mma_body_ms"],
        "dit256_train": {k: dit_bwd_row[k] for k in ("shape", "kernel_ms", "library_ms",
                                                     "bound_ms", "plain_ms", "max_abs_err")},
        "launches_dit256_train": dit_train["launches"]["attn_bwd"],
        "latent256_train": latent_row(latent_bwd_row),
        "launches_latent256_train": latent_train["launches"]["attn_bwd"],
        "launches_short_train": {k: v["launches"]["attn_bwd"]
                                 for k, v in dit_train["short"].items()},
        "classifier_f32": [latent_row(r) for r in clf_phase["bwd_rows"]],
        "launches_classifier": clf_launches("attn_bwd"),
        "shapes": bwd_rows,
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_fwd_sm90.cu",
        "source_float32": "eo_diffusion_torch/ops/csrc/attention_f32_sm90.cu",
        "replaces": "eo_diffusion_tpu/ops/attention.py:271",
        "replaces_also": "eo_diffusion_tpu/ops/attention.py:227",
        "launches": res512["launches"]["flash_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows if r["dtype"] == "bfloat16"),
        "ms": flash_rows[0]["kernel_ms"],
        "plain_ms": flash_rows[0]["plain_ms"],
        "bound_ms": flash_rows[0]["bound_ms"],
        "bound_by": flash_rows[0]["bound_by"],
        "library_ms": flash_rows[0]["library_ms"],
        "launches_train_512": train512["launches"]["flash_fwd"],
        "mma_body_ms": flash_rows[0]["mma_body_ms"],
        "shapes": flash_rows,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_bwd_sm90.cu",
        "source_float32": "eo_diffusion_torch/ops/csrc/attention_f32_sm90.cu",
        "replaces": "eo_diffusion_tpu/ops/attention.py:502",
        "replaces_also": "eo_diffusion_tpu/ops/attention.py:669",
        "launches": train512["launches"]["flash_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_bwd_rows
                           if r["dtype"] == "bfloat16"),
        "ms": flash_bwd_rows[0]["kernel_ms"],
        "plain_ms": flash_bwd_rows[0]["plain_ms"],
        "bound_ms": flash_bwd_rows[0]["bound_ms"],
        "bound_by": flash_bwd_rows[0]["bound_by"],
        "library_ms": flash_bwd_rows[0]["library_ms"],
        "launches_train_512": train512["launches"]["flash_bwd"],
        "mma_body_ms": flash_bwd_rows[0]["mma_body_ms"],
        "shapes": flash_bwd_rows,
    }, *wide_kernel_rows(
        wide_rows, wide_bwd_rows, wide512,
        {"launches_64px_restore":
         clf_phase["restore"]["inria64_inpaint"]["launches"]["wide_fwd"],
         "launches_short_train": dit_train["short"]["inria64"]["launches"]["wide_fwd"],
         "old_body_launches_on_model_paths": old_wide_launches("wide_fwd_resident"),
         "sass": sass["attention_wide"]},
        {"launches_short_train": dit_train["short"]["inria64"]["launches"]["wide_bwd"],
         "old_body_launches_on_model_paths": old_wide_launches("wide_bwd_resident"),
         "sass": sass["attention_wide"]}), *f32_kernel_rows(
        f32_rows, f32_bwd_rows, f32_phase,
        {"launches_classifier": clf_launches("attn_fwd_f32"),
         "classifier_rows": [latent_row(r) for r in clf_phase["attn_rows"]],
         "fma_launches_on_model_paths": old_wide_launches("attn_fwd_mma")
         + old_wide_launches("flash_fwd_mma"),
         "sass": sass["attention_f32_sm90"]},
        {"launches_classifier": clf_launches("attn_bwd_f32"),
         "classifier_rows": [latent_row(r) for r in clf_phase["bwd_rows"]],
         "fma_launches_on_model_paths": old_wide_launches("attn_bwd_mma")
         + old_wide_launches("flash_bwd_mma"),
         "ptxas": sass["attention_f32_sm90_ptxas"]}), {
        "name": "int8_attention_fwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/int8_attention.cu",
        "replaces": "tools/probe_int8_attn.py:82",
        "launches": probe_launches["int8"],
        "max_abs_err": max(r["max_abs_err"] for r in int8_rows),
        "ms": int8_rows[0]["kernel_ms"],
        "plain_ms": int8_rows[0]["plain_ms"],
        "bound_ms": int8_rows[0]["bound_ms"],
        "bound_by": int8_rows[0]["bound_by"],
        "library_ms": int8_rows[0]["library_ms"],
        "library_call": "F.scaled_dot_product_attention in bf16 (not quantised)",
        "flash_bf16_ms": int8_rows[0]["flash_ms"],
        "probe": probe,
        "shapes": int8_rows,
    }] + [{
        "name": f"group_norm_{direction}",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/group_norm_sm90.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in gn if r["dtype"] == "bfloat16"),
        "ms": gn[0]["kernel_ms"],
        "plain_ms": gn[0]["plain_ms"],
        "bound_ms": gn[0]["bound_ms"],
        "bound_by": gn[0]["bound_by"],
        "library_ms": gn[0]["library_ms"],
        "old_body_ms": gn[0]["old_body_ms"],
        "old_body_source": "eo_diffusion_torch/ops/csrc/group_norm.cu",
        "old_body_launches_on_model_paths": sum(
            r["launches"][f"gn_{direction}_legacy"]
            for r in (main_res, res512, res64, train_res, train512, tiled, tiled_flow,
                      *dit_res.values(), *latent_runs, *guided_runs, *edm_runs, *clf_runs,
                      *few_runs)),
        **extra,
        "shapes": gn,
    } for direction, replaces, launches, gn, extra in (
        ("fwd", "eo_diffusion_tpu/ops/group_norm.py:48", main_res["launches"]["gn_fwd"],
         gn_fwd_rows, {"launches_clouds64": res64["launches"]["gn_fwd"],
                       "launches_train": train_res["launches"]["gn_fwd"],
                       "stats_max": {"mean_err_std_units": max(r["mean_err_std_units"]
                                                               for r in gn_fwd_rows),
                                     "rstd_rel_err": max(r["rstd_rel_err"]
                                                         for r in gn_fwd_rows)},
                       "lost_chunk_min_reading": min(max(r["lost_chunk_reading"].values())
                                                     for r in gn_fwd_rows
                                                     if "lost_chunk_reading" in r),
                       "latent256_ae_f32": [latent_row(r[0]) for r in ae_gn_rows],
                       "launches_latent256": {
                           "ae_train": latent_train["ae_launches"]["gn_fwd"],
                           "dit_train": latent_train["launches"]["gn_fwd"],
                           "sample": latent_train["sample_launches"]["gn_fwd"]},
                       "cfg_n16": [latent_row(r[0]) for r in cfg_gn_rows],
                       "launches_guidance": {tag: r["launches"]["gn_fwd"]
                                             for tag, r in guided["runs"].items()},
                       "launches_guidance_tiled": guided["tiled"]["launches"]["gn_fwd"],
                       "launches_edm_bridge": edm_launches("gn_fwd"),
                       "classifier_f32_n8": [latent_row(r[0]) for r in clf_phase["gn_rows"]],
                       "launches_classifier": clf_launches("gn_fwd")}),
        ("bwd", "eo_diffusion_tpu/ops/group_norm.py:104", train_res["launches"]["gn_bwd"],
         gn_bwd_rows, {"latent256_ae_f32": [latent_row(r[1]) for r in ae_gn_rows],
                       "cfg_n16": [latent_row(r[1]) for r in cfg_gn_rows],
                       "launches_edm_bridge": edm_launches("gn_bwd"),
                       "classifier_f32_n8": [latent_row(r[1]) for r in clf_phase["gn_rows"]],
                       "launches_classifier": clf_launches("gn_bwd"),
                       "launches_latent256": {
                           "ae_train": latent_train["ae_launches"]["gn_bwd"],
                           "dit_train": latent_train["launches"]["gn_bwd"]}}))]
    qk = mm["variants"][0]  # QK^T as shipped, one launch
    sm90_rows = [r for r in wgrad_rows if "sm90_ms" in r]
    kernels += [{
        "name": "conv_wgrad",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/conv_wgrad.cu",
        "replaces": "tools/prototype_wgrad_kernel.py:40",
        "launches": sweep["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in wgrad_rows if r["dtype"] == "bfloat16"),
        "ms": wgrad_rows[0]["kernel_ms"],
        "plain_ms": wgrad_rows[0]["plain_ms"],
        "bound_ms": wgrad_rows[0]["bound_ms"],
        "bound_by": wgrad_rows[0]["bound_by"],
        "library_ms": wgrad_rows[0]["library_ms"],
        "library_call": "aten.convolution_backward, weight gradient only (cuDNN)",
        "sites": sweep["sites"],
        "sites_sums": sweep["sums"],
        "sites_max_cudnn_rel_err": sweep["max_cudnn_rel_err"],
        "shapes": wgrad_rows[:5],
    }, {
        "name": "conv_wgrad_sm90",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/conv_wgrad_sm90.cu",
        "replaces": "tools/prototype_wgrad_kernel.py:40",
        "launches": train_res["launches"]["wgrad_sm90"],
        "max_abs_err": max(r["sm90_max_abs_err"] for r in sm90_rows),
        "ms": wgrad_rows[0]["sm90_ms"],
        "was_ms": wgrad_rows[0]["kernel_ms"],
        "plain_ms": wgrad_rows[0]["plain_ms"],
        "bound_ms": wgrad_rows[0]["bound_ms"],
        "bound_by": wgrad_rows[0]["bound_by"],
        "library_ms": wgrad_rows[0]["library_ms"],
        "library_call": "aten.convolution_backward, weight gradient only (cuDNN)",
        "delta_checks": wgrad_deltas,
        "launches_edm_bridge": edm_launches("wgrad_sm90"),
        "sites": sweep["sites"],
        "sites_routes": sweep["routes"],
        "sites_sums": sweep["sums"],
        "sites_max_cudnn_rel_err": sweep["max_sm90_cudnn_rel_err"],
        "shapes": sm90_rows,
    }, {
        "name": "attn_matmul_probe",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attn_probes.cu",
        "replaces": "tools/probe_attn_matmuls.py:38",
        "launches": mm["launches"],
        "max_abs_err": max(v["max_abs_err"] for v in mm["variants"]),
        "ms": qk["launch_ms"],
        "plain_ms": qk["plain_launch_ms"],
        "bound_ms": qk["launch_bound_ms"],
        "bound_by": qk["bound_by"],
        "library_ms": qk["library_bmm_ms"],
        "library_call": "torch.bmm in bf16 (bf16 output, one product)",
        "shapes": mm["variants"],
    }, {
        "name": "attention_fwd_transposed",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attn_probes.cu",
        "replaces": "tools/probe_packed_pv.py:52",
        "launches": packed["launches"],
        "max_abs_err": attn_t_rows[0]["max_abs_err"],
        "ms": attn_t_rows[0]["kernel_ms"],
        "plain_ms": attn_t_rows[0]["plain_ms"],
        "bound_ms": attn_t_rows[0]["bound_ms"],
        "bound_by": attn_t_rows[0]["bound_by"],
        "library_ms": attn_t_rows[0]["library_ms"],
        "shipped_ms": packed["shipped_ms"],
        "shapes": attn_t_rows,
    }]
    kernels += probe_kernel_rows(small, probes)
    # phase 5k's launches, rows and forward-mode readings beside each kernel's
    for row in few_kernel_rows(few):
        entry = next(k for k in kernels if k["name"] == row["name"])
        entry.update({f"few_{key}": row[key] for key in ("launches", "ms", "plain_ms",
                                                         "bound_ms", "library_ms")},
                     launches_few=row["launches_few"], few_shapes=row["shapes"],
                     **({"jvp_rule": row["jvp_rule"]} if "jvp_rule" in row else {}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
