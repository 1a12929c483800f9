"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

1. require CUDA; print the card's name and power limit; TF32 off;
2. build every CUDA kernel of the port from the sources in this checkout,
   and count the wgmma (HGMMA) and TMA (UTMALDG) instructions of the bf16
   attention forward and backward;
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
   the new head order, every gradient finite;
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
   no separate-tensor or GroupNorm launch;
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
   by ``cli.inference --sampler flow`` (Heun-8), then ``flow64`` and
   ``dit64`` for 4 steps each, the launches as their forwards give them;
   7e. evaluation: ``cli.inference --metrics --samples_fid`` on 7c's
   checkpoint and test split, ``metrics.txt`` against SSIM/PSNR recomputed
   on the CPU from the same samples; ``cli.evaluate --extractor offline``
   over the ground truth's and the samples' PNGs; the FeatureCNN of
   ``gallery/eval_extractor256.npz``, the random projection and InceptionV3
   at 299 px, batch 8, seeded weights, each on the card against the CPU;
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
fused-qkv kernel at the DiT's shapes; phase 4c holds a DiT-B/8 forward at 256
px and a DiT-B/4 call at the latent256 shape against the all-plain model.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
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
from eo_diffusion_torch.models.unet import UNet, unet_clouds
from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.cli import evaluate as cli_evaluate
from eo_diffusion_torch.diffusion.flow import FlowMatching
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
from eo_diffusion_torch.diffusion.tiled import tiled_ddim_sample
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
                                             card_line, cuda_ms, queued_ms)
from eo_diffusion_torch.train.checkpoint import restore_checkpoint
from eo_diffusion_torch.weights import randomize_parameters

PEAK_FLOPS = {torch.bfloat16: PEAK_BF16, torch.float32: PEAK_F32}
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
# phase 7c: a SEN12MS-CR tree of SEN12_SCENES x SEN12_PATCHES triplets at
# 256 px (s1: 2 bands float32; s2, s2_cloudy: 13 bands uint16), 54 of them in
# the train split (batches of 8: 6 a epoch), 10 in the test split
SEN12_SCENES, SEN12_PATCHES, SEN12_SIZE = 4, 16, 256
SEN12_EPOCHS = 2


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
    if dtype == torch.bfloat16 and not with_lse:  # the wgmma/TMA body, unit-normal inputs
        unit = torch.randn(b, t, 3 * c, generator=gen, device="cuda").to(dtype)
        strict = strict_check(lambda: A.qkv_attention_cuda(unit, heads, new_order).reshape(
            b, t, heads, d), *A.split_qkv(unit, heads, new_order), chunk=b,
            what=f"fused-qkv entry at B{b} T{t} H{heads} D{d} new_order={new_order}")
        del unit

    reps = 20 if t >= 1024 else 100
    kernel_ms = cuda_ms(lambda: A.qkv_attention_cuda(qkv, heads, new_order,
                                                     return_lse=with_lse), reps)
    mma_ms = cuda_ms(lambda: A.qkv_attention_mma_cuda(qkv, heads, new_order,
                                                      return_lse=with_lse), reps)
    plain_ms = cuda_ms(lambda: A.attention_from_qkv(qkv, heads, new_order, impl="plain"),
                       3 if t >= 1024 else 20, warmup=1)
    q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous() for x in A.split_qkv(qkv, heads, new_order))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                scale=1.0 / math.sqrt(d)), reps)
    flops = 4.0 * b * heads * t * t * d
    nbytes = qkv.element_size() * b * t * 4 * c + (4 * b * heads * t if with_lse else 0)
    bound_ms = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S) * 1e3
    row = {"shape": f"B{b} T{t} H{heads} D{d}", "dtype": str(dtype).split(".")[-1],
           "new_order": new_order, "max_abs_err": err, "max_scaled_err": scaled,
           "unit_normal": strict, "kernel_ms": kernel_ms, "mma_body_ms": mma_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES_PER_S
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
    # the library's yardstick: the backward of scaled_dot_product_attention alone
    q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous().requires_grad_()
                  for x in A.split_qkv(qkv, heads, new_order))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0 / math.sqrt(d))
    g4 = dout.reshape(shape).permute(0, 2, 1, 3).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True),
                         10 if big else 50)
    flops = 10.0 * b * heads * t * t * d
    # q, k, v, o, do read and dq, dk, dv written once each, plus the lse
    nbytes = qkv.element_size() * b * t * 8 * c + 4 * b * heads * t
    bound_ms = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S) * 1e3
    row = {"shape": f"B{b} T{t} H{heads} D{d}", "dtype": str(dtype).split(".")[-1],
           "new_order": new_order, "grad_rms": rms, "max_abs_err": err,
           "max_scaled_err": scaled, "mma_body_max_scaled_err": mma_scaled,
           "unit_normal": strict, "kernel_ms": kernel_ms, "mma_body_ms": mma_ms, **queued,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    print("attention_bwd " + json.dumps(row), flush=True)
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


def flash_case(b, t, heads, d, dtype, layout, gen, chunk=None):
    """The separate-tensor forward entry vs plain (with the lse) on one
    shape, timed without the lse as sampling runs it; returns a result row."""
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
    if dtype == torch.bfloat16:  # the wgmma/TMA body at unit-normal inputs
        uq, uk, uv = make_planes(b, t, heads, d, dtype, layout, gen, sharpen=False)
        strict = strict_check(lambda: A.flash_attention_cuda(uq, uk, uv), uq, uk, uv, chunk,
                              f"separate-tensor entry at {label}")
        del uq, uk, uv

    big = t >= 8192
    reps = 10 if big else 20
    kernel_ms = cuda_ms(lambda: A.flash_attention_cuda(q, k, v), reps)
    mma_ms = (cuda_ms(lambda: A.flash_attention_mma_cuda(q, k, v), reps)
              if d <= 128 else None)  # the mma.sync body takes D up to 128
    plain_ms = cuda_ms(lambda: plain_fwd(q, k, v, chunk, with_lse=False), 2 if big else 3,
                       warmup=1)
    torch.cuda.empty_cache()
    q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                scale=1.0 / math.sqrt(d)), reps)
    del q4, k4, v4
    flops = 4.0 * b * heads * t * t * d
    nbytes = q.element_size() * b * t * heads * d * 4  # q, k, v read, o written
    bound_ms = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S) * 1e3
    row = {"shape": label, "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "max_scaled_err": scaled, "lse_max_abs_err": lse_err, "unit_normal": strict,
           "kernel_ms": kernel_ms, "mma_body_ms": mma_ms,
           "plain_ms": plain_ms, "plain_chunk": chunk, "library_ms": library_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    print("flash_fwd " + json.dumps(row), flush=True)
    return row


def max_scaled_bwd_err(got, ref, rms):
    """The largest |got - plain| / max(rms, |plain|) over dq, dk and dv."""
    return max(((a.float() - w.float()).abs() / w.float().abs().clamp(min=rms)).max().item()
               for a, w in zip(got, ref))


def flash_bwd_case(b, t, heads, d, dtype, layout, gen, ugen, hchunk):
    """The separate-tensor backward entry vs plain on one shape (o and lse
    from the forward entry), and the mma.sync body on the same tensors (D up
    to 128); the unit-normal check draws from ``ugen``. Returns a result
    row."""
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
    if dtype == torch.bfloat16:  # the wgmma/TMA body at unit-normal inputs
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
    plain_ms = cuda_ms(plain, 1 if big else 2, warmup=1)
    torch.cuda.empty_cache()
    q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous().requires_grad_() for x in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0 / math.sqrt(d))
    g4 = dout.permute(0, 2, 1, 3).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True),
                         5 if big else 10)
    del q4, k4, v4, o4, g4
    flops = 10.0 * b * heads * t * t * d
    # q, k, v, o, do read and dq, dk, dv written once each, plus the lse
    nbytes = q.element_size() * b * t * heads * d * 8 + 4 * b * heads * t
    bound_ms = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S) * 1e3
    row = {"shape": label, "dtype": str(dtype).split(".")[-1], "grad_rms": rms,
           "max_abs_err": err, "max_scaled_err": scaled, "mma_body_max_scaled_err": mma_scaled,
           "unit_normal": strict,
           "kernel_ms": kernel_ms, "mma_body_ms": mma_ms, "plain_ms": plain_ms,
           "plain_heads_a_chunk": hchunk, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    print("flash_bwd " + json.dumps(row), flush=True)
    return row


def sass_census(lib):
    """Instructions of a built library by kind (cuobjdump -sass): HGMMA is
    wgmma.mma_async, UTMALDG a TMA tile load (cp.async.bulk.tensor), LDL/STL
    register spills."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "SYNCS", "LDL", "STL")}


def reset_counts():
    A.qkv_attention_cuda.launches = A.qkv_attention_bwd_cuda.launches = 0
    A.flash_attention_cuda.launches = A.flash_attention_bwd_cuda.launches = 0
    A.qkv_attention_mma_cuda.launches = A.flash_attention_mma_cuda.launches = 0
    A.qkv_attention_bwd_mma_cuda.launches = A.flash_attention_bwd_mma_cuda.launches = 0
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
    return {"attn_fwd": qkv * forwards, "attn_bwd": qkv * backwards,
            "flash_fwd": flash * forwards, "flash_bwd": flash * backwards,
            "attn_fwd_mma": 0, "flash_fwd_mma": 0, "attn_bwd_mma": 0, "flash_bwd_mma": 0,
            "gn_fwd": GN_PER_FORWARD * forwards, "gn_bwd": GN_PER_FORWARD * backwards,
            "gn_fwd_legacy": 0, "gn_bwd_legacy": 0, "int8": 0, "wgrad": wg["mma"] * backwards,
            "wgrad_sm90": wg["sm90"] * backwards, "mm_probe": 0, "attn_t": 0, "hybrid": 0, "stats": 0,
            "transpose": 0, "variant": 0}


def dit_expected(forwards, backwards=0):
    """The launch counts of ``forwards`` DiT forwards and ``backwards``
    backwards: the fused-qkv kernel (with the lse in training) and its
    backward once a block each, nothing else."""
    return {**{k: 0 for k in counts()}, "attn_fwd": DIT_DEPTH * forwards,
            "attn_bwd": DIT_DEPTH * backwards}


def unet_train_expected(cfg, size, batch, steps):
    """The launch counts of ``steps`` training steps of ``cfg``'s UNet at
    ``size`` px and ``batch``: the attention and GroupNorm launches one
    forward gives on the card (read with the counters), forward and backward
    each step, and the routed 3x3 convs' weight gradients."""
    model = UNet(dataclasses.replace(cfg, image_size=size)).cuda().eval()
    x = torch.zeros(1, size, size, cfg.in_channels, device="cuda")
    with torch.inference_mode():
        reset_counts()
        model(x, torch.zeros(1, dtype=torch.long, device="cuda"))
        per = counts()
    del model
    wg = wgrad_routes(cfg, size, batch, sites=None)
    return {**{k: 0 for k in per},
            **{k: per[k] * steps for k in ("attn_fwd", "flash_fwd", "gn_fwd")},
            "attn_bwd": per["attn_fwd"] * steps, "flash_bwd": per["flash_fwd"] * steps,
            "gn_bwd": per["gn_fwd"] * steps, "wgrad": wg["mma"] * steps,
            "wgrad_sm90": wg["sm90"] * steps}


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


def gn_case(n, hw, c, groups, act, dtype, gen, film=False, loc=0.0, fault=False):
    """GroupNorm kernels (forward, then backward from the kernel's mean and
    rstd) vs their plain versions on one shape, with timings, the old body
    (group_norm.cu) timed on the same tensors; the statistics against
    float64, and with ``fault`` a planted lost chunk asserted caught by the
    same check. Returns the forward and backward result rows."""
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
    del xl, yl, dyl
    esize = x.element_size()
    rows = []
    for direction, kms, oms, pms, lms, e, s in (
            ("fwd", fwd_ms, old_fwd, fwd_plain, lib_fwd, err, sc),
            ("bwd", bwd_ms, old_bwd, bwd_plain, lib_bwd, dx_err, dx_sc)):
        bound, by = gn_bound_ms(direction, act, n, hw, c, groups, esize)
        p = plans[direction]
        row = {"shape": label, "dtype": str(dtype).split(".")[-1], "max_abs_err": e,
               "max_scaled_err": s, "kernel_ms": kms, "old_body_ms": oms, "plain_ms": pms,
               "library_ms": lms, "bound_ms": bound, "bound_by": by,
               "plan": {"mode": p.mode, "teams": p.teams, "blocks": p.blocks,
                        "chunk_rows": p.chunk_rows, "held_rows": p.held_rows,
                        "threads": p.threads, "smem_bytes": p.smem_bytes}}
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


def dit_train_check(cfg, batch, gen, label):
    """One flow-matching loss and backward of the DiT with the kernels
    against the all-plain model (``DiT.set_impl("plain")``): same weights,
    batch, times and noise. The forward's velocity and the gradients by
    their relative L2 difference (phase 4's limits); every parameter gets a
    finite gradient, the qkv weights a non-zero one; K1 with the lse and K4
    once a block, nothing else."""
    model = randomize_parameters(DiT(cfg), seed=1).cuda().train()
    s = cfg.image_size
    flow = FlowMatching.create(image_size=s, in_channels=cfg.out_channels)
    x0 = torch.randn(batch, s, s, cfg.in_channels, generator=gen, device="cuda")
    noise = torch.randn(batch, s, s, cfg.in_channels, generator=gen, device="cuda")
    t = torch.linspace(0.02, 0.98, batch, device="cuda")
    preds, losses, grads, launched = {}, {}, {}, {}
    for impl in ("auto", "plain"):
        model.set_impl(impl).zero_grad(set_to_none=True)

        def model_fn(x, tt, c, y, impl=impl):
            out = model(x, tt)
            preds[impl] = out.detach().float()
            return out

        reset_counts()
        loss = flow.train_loss(model_fn, x0, t=t, noise=noise)
        loss.backward()
        torch.cuda.synchronize()
        launched[impl] = counts()
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    del model
    assert launched["auto"] == dit_expected(1, 1), launched["auto"]
    assert not any(launched["plain"].values()), launched["plain"]
    fwd_rel = ((preds["auto"] - preds["plain"]).norm() / preds["plain"].norm()).item()
    num = den = 0.0
    for name, gk in grads["auto"].items():
        gp = grads["plain"][name]
        assert torch.isfinite(gk).all(), f"non-finite gradient of {name}"
        if name.endswith("qkv.weight"):
            assert gk.abs().max().item() > 0, f"{name} got no gradient"
        num += (gk - gp).pow(2).sum().item()
        den += gp.pow(2).sum().item()
    grad_rel = math.sqrt(num / den)
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
    each, with the launches their forwards give."""
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
    for preset in ("flow64", "dit64"):
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


def run_cli(argv, cfg, seed, tmp):
    """Run the inference entry point in-process with seeded random weights
    (saved as a state dict and passed with --ckpt)."""
    ckpt = os.path.join(tmp, f"weights_{seed}.pt")
    torch.save(randomize_parameters(build_denoiser(cfg), seed).state_dict(), ckpt)
    args = cli.parse_args(argv + ["--ckpt", ckpt, "--outdir", os.path.join(tmp, "out"),
                                  "--seed", str(seed)])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = cli.main(args)
    res["launches"] = counts()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    x = res["samples"]
    assert x is not None and bool(torch.isfinite(torch.as_tensor(x)).all()), "non-finite samples"
    return res


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


def main() -> int:
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

    # 4d. a dit256 (DiT-B/8) flow-matching loss and backward at 256 px, batch
    # 16: K1 with the lse and K4 in the new head order inside a model
    dit_grad = dit_train_check(dit_b(256, dtype=torch.bfloat16), DIT_TRAIN_BATCH, dgen,
                               "DiT-B/8 256 px")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
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

        # 5c. the same scenes tiled: the 256 px denoiser over 3 x 3 tiles
        tiled = run_tiled(sen.unet_config(cond_channels=3), seed=2, gen=gen, n=8,
                          steps=STEPS_512)
        print(f"tiled_ddim_sample 512x512 tile 256 overlap 0.5 DDIM-{STEPS_512} b8: "
              f"{tiled['images']} scenes in {tiled['seconds']:.3f} s = "
              f"{tiled['images'] / tiled['seconds']:.4f} img/s (whole scene "
              f"{res512['sample_seconds']:.3f} s), kernel launches {tiled['launches']}, "
              f"peak memory {tiled['peak_mem_gb']:.2f} GiB; {card}", flush=True)

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

        # 7b. the training entry point at 512 px, batch 4
        train512 = run_train_512(tmp, seed=5)
        steady = train512["step_seconds"][2:]
        sps512 = len(steady) / sum(steady)
        print(f"training path sen12mscr256 --image_size 512 b4 bf16: {train512['steps']} "
              f"steps in {train512['seconds']:.3f} s; steady {sps512:.4f} steps/s = "
              f"{4 * sps512:.4f} img/s; loss {train512['losses'][0]:.5f} -> "
              f"{train512['losses'][-1]:.5f}; launches {train512['launches']}; peak memory "
              f"{train512['peak_mem_gb']:.2f} GiB; {card}", flush=True)

        # 7c. the SEN12MS-CR feed at full width: GeoTIFFs on disk to the card
        sen = phase_7c(tmp, card, train_res)

        # 7d. DiT and flow training through the entry point
        dit_train = run_train_dit(tmp, seed=10, card=card)

        # 7e. evaluation: SSIM/PSNR in the sampling CLI, cli.evaluate, the extractors
        evaluation = phase_7e(tmp, card, sen)

    # 8. the W8A8 attention probe, once
    reset_counts()
    probe = probe_int8_attn.run(seed=0)
    probe_launches = counts()
    assert probe_launches["int8"] > 0, probe_launches
    print("probe_int8_attn " + json.dumps(probe), flush=True)

    # 8b. the conv weight-gradient kernel and the attention-matmul probes
    wgrad_rows, wgrad_deltas, attn_t_rows, sweep, mm, packed = phase_8b(gen, card)

    # 8c. the softmax-orientation probes and the attention variants
    small, probes = phase_8c(gen)

    # 9. the result lines
    main_row = rows[0]
    bwd_row = bwd_rows[0]
    gn_fwd_rows, gn_bwd_rows = [r[0] for r in gn_rows], [r[1] for r in gn_rows]
    sm90_rows = [r for r in rows + flash_rows if r["dtype"] == "bfloat16"]
    sm90_bwd_rows = [r for r in bwd_rows + flash_bwd_rows if r["dtype"] == "bfloat16"]
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
                                       *dit_res.values())
            for k in ("attn_fwd_mma", "flash_fwd_mma")),
        "unit_normal_max": attention_maxima(r["unit_normal"] for r in sm90_rows
                                            if r["unit_normal"]),
        "sass": sass["attention_fwd_sm90"],
        "shapes": [{k: r[k] for k in ("shape", "kernel_ms", "mma_body_ms", "library_ms",
                                      "bound_ms", "plain_ms", "max_abs_err")}
                   for r in sm90_rows],
    }, {
        "name": "qkv_attention_fwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_fwd_sm90.cu",
        "source_float32": "eo_diffusion_torch/ops/csrc/attention_fwd.cu",
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
        "mma_body_launches_on_model_paths": sum(
            r["launches"][k] for r in (main_res, res512, res64, train_res, train512, tiled,
                                       *dit_res.values())
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
        "source_float32": "eo_diffusion_torch/ops/csrc/attention_bwd.cu",
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
        "launches_short_train": {k: v["launches"]["attn_bwd"]
                                 for k, v in dit_train["short"].items()},
        "shapes": bwd_rows,
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_fwd_sm90.cu",
        "source_float32": "eo_diffusion_torch/ops/csrc/attention_fwd.cu",
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
        "source_float32": "eo_diffusion_torch/ops/csrc/attention_bwd.cu",
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
    }, {
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
            for r in (main_res, res512, res64, train_res, train512, tiled, *dit_res.values())),
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
                                                     if "lost_chunk_reading" in r)}),
        ("bwd", "eo_diffusion_tpu/ops/group_norm.py:104", train_res["launches"]["gn_bwd"],
         gn_bwd_rows, {}))]
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
