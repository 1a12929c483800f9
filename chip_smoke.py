"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

1. require CUDA; print the card's name and power limit; TF32 off;
2. build every CUDA kernel of the port from the sources in this checkout;
3. hold each kernel (attention forward through its fused-qkv entry and
   through its separate-tensor entry, attention backward through both,
   GroupNorm + FiLM + SiLU forward and backward) against its plain PyTorch
   version on the card at the shapes the main paths give it (the clouds UNet
   at 256, 384 and 512 px), and time kernel, plain version, the PyTorch
   library call and the card's lower bound;
4. one clouds-UNet forward at 256 px, kernels against the all-plain model
   (plain attention and plain norms), then one loss and backward, kernels
   against plain: every parameter gets a finite gradient, the attention's
   qkv weights a non-zero one; 4b. the same at 384 px, batch 1, where every
   attention takes the separate-tensor route;
5. the sampling path through the entry point: ``eo_diffusion_torch.cli.inference``
   with ``sen12mscr256`` (concat cloud removal), DDIM-50, batch 8, seeded
   random weights; the attention counter must rise by 11 x 50 per batch and
   the GroupNorm counter by 56 x 50; 5b. the same entry point at
   ``--image_size 512``, DDIM-20 (5 separate-tensor and 6 fused-qkv
   launches a forward); 5c. ``tiled_ddim_sample`` of 512 x 512 scenes with
   the 256 px denoiser (3 x 3 tiles at overlap 0.5, DDIM-20);
6. the reference's own 64 px path: ``clouds64-attn`` RePaint DDPM-100;
7. the training path through the entry point: ``eo_diffusion_torch.cli.train``
   with ``sen12mscr256`` at full width and depth, batch 8, bf16, a few
   steps from seeded weights; the attention counters must rise by 11 a step
   and the GroupNorm counters by 56; the checkpoint restores and the
   sampling entry point samples from it; 7b. the same entry point at
   ``--image_size 512``, batch 4 (attention forward and backward 5 + 6 a
   step);
8. print the ``{"kernels": [...]}`` line, the card line and, last, the
   ``{"ok": true, ...}`` line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

from eo_diffusion_torch.cli import inference as cli
from eo_diffusion_torch.cli import train as cli_train
from eo_diffusion_torch.cli.presets import get_preset
from eo_diffusion_torch.models.unet import UNet, unet_clouds
from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
from eo_diffusion_torch.diffusion.tiled import tiled_ddim_sample
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.ops import group_norm as G
from eo_diffusion_torch.train.checkpoint import restore_checkpoint
from eo_diffusion_torch.weights import randomize_parameters

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor cores,
# float32 without tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
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
# f32 operations an element (not on the tensor cores): forward statistics
# and affine 5, SiLU 4 more; backward 11, SiLU's derivative 8 more
GN_OPS = {("fwd", "none"): 5, ("fwd", "silu"): 9, ("bwd", "none"): 11, ("bwd", "silu"): 19}
TRAIN_STEPS = 8
TRAIN_STEPS_512 = 6
STEPS_512 = 20  # DDIM steps of the 512 px whole-scene and tiled runs


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

    reps = 20 if t >= 1024 else 100
    kernel_ms = cuda_ms(lambda: A.qkv_attention_cuda(qkv, heads, new_order,
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
           "new_order": new_order, "max_abs_err": err, "max_scaled_err": scaled, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    if with_lse:
        row["lse_max_abs_err"] = lse_err
    print("attention " + json.dumps(row), flush=True)
    return row


def attention_bwd_case(b, t, heads, d, dtype, new_order, gen):
    """Backward kernel vs plain on one shape (o and lse from the forward
    kernel); returns a result row."""
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
    assert math.isfinite(err) and scaled <= TOL_BWD[dtype], (
        f"backward kernel vs plain at B{b} T{t} H{heads} D{d} {dtype}: {scaled} > "
        f"{TOL_BWD[dtype]}")
    del ref

    big = t >= 1024
    kernel_ms = cuda_ms(lambda: A.qkv_attention_bwd_cuda(qkv, out, lse, dout, heads, new_order),
                        10 if big else 50)
    plain_ms = cuda_ms(plain, 2 if big else 10, warmup=1)
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
           "max_scaled_err": scaled, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    print("attention_bwd " + json.dumps(row), flush=True)
    return row


def make_planes(b, t, heads, d, dtype, layout, gen):
    """q, k, v [B, T, H, D]: the split_qkv views of one projection in either
    head order ("legacy", "new"), or three contiguous tensors; q and k x2."""
    if layout == "contiguous":
        q, k, v = (torch.randn(b, t, heads, d, generator=gen, device="cuda") for _ in range(3))
        q.mul_(2.0)
        k.mul_(2.0)
        return [x.to(dtype) for x in (q, k, v)]
    qkv = torch.randn(b, t, 3 * heads * d, generator=gen, device="cuda")
    q, k, _ = A.split_qkv(qkv, heads, layout == "new")
    q.mul_(2.0)
    k.mul_(2.0)
    return list(A.split_qkv(qkv.to(dtype), heads, layout == "new"))


def plain_fwd(q, k, v, chunk, with_lse=True):
    """The plain forward, ``chunk`` samples at a time (its [B, H, T, T] f32
    scores at B8 T16384 H8 would take 69 GB); the same function."""
    res = [A.reference_attention(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk],
                                 return_lse=with_lse) for i in range(0, q.shape[0], chunk)]
    if not with_lse:
        return torch.cat(res)
    return torch.cat([r[0] for r in res]), torch.cat([r[1] for r in res])


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

    big = t >= 8192
    reps = 10 if big else 20
    kernel_ms = cuda_ms(lambda: A.flash_attention_cuda(q, k, v), reps)
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
           "max_scaled_err": scaled, "lse_max_abs_err": lse_err, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "plain_chunk": chunk, "library_ms": library_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    print("flash_fwd " + json.dumps(row), flush=True)
    return row


def flash_bwd_case(b, t, heads, d, dtype, layout, gen, hchunk):
    """The separate-tensor backward entry vs plain on one shape (o and lse
    from the forward entry); returns a result row."""
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
    assert math.isfinite(err) and scaled <= TOL_BWD[dtype], (
        f"flash backward vs plain at {label} {dtype}: {scaled} > {TOL_BWD[dtype]}")
    del got, ref, diff
    torch.cuda.empty_cache()

    big = t >= 8192
    kernel_ms = cuda_ms(lambda: A.flash_attention_bwd_cuda(q, k, v, out, lse, dout),
                        5 if big else 10)
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
           "max_abs_err": err, "max_scaled_err": scaled, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "plain_heads_a_chunk": hchunk, "library_ms": library_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES_PER_S
           else "bytes"}
    print("flash_bwd " + json.dumps(row), flush=True)
    return row


def reset_counts():
    A.qkv_attention_cuda.launches = A.qkv_attention_bwd_cuda.launches = 0
    A.flash_attention_cuda.launches = A.flash_attention_bwd_cuda.launches = 0
    G.group_norm_fwd_cuda.launches = G.group_norm_bwd_cuda.launches = 0


def counts():
    return {"attn_fwd": A.qkv_attention_cuda.launches,
            "attn_bwd": A.qkv_attention_bwd_cuda.launches,
            "flash_fwd": A.flash_attention_cuda.launches,
            "flash_bwd": A.flash_attention_bwd_cuda.launches,
            "gn_fwd": G.group_norm_fwd_cuda.launches, "gn_bwd": G.group_norm_bwd_cuda.launches}


def expected(size, forwards, backwards=0):
    """The launch counts of ``forwards`` UNet forwards and ``backwards``
    backwards at ``size`` px."""
    qkv, flash = ROUTES[size]
    return {"attn_fwd": qkv * forwards, "attn_bwd": qkv * backwards,
            "flash_fwd": flash * forwards, "flash_bwd": flash * backwards,
            "gn_fwd": GN_PER_FORWARD * forwards, "gn_bwd": GN_PER_FORWARD * backwards}


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


def gn_case(n, hw, c, groups, act, dtype, gen, film=False, loc=0.0):
    """GroupNorm kernels (forward, then backward from the kernel's mean and
    rstd) vs their plain versions on one shape, with timings; returns the
    forward and backward result rows."""
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
    # the statistics against float64, and the sum-of-squares recipe of the TPU
    # kernel (E[x^2] - E[x]^2 in f32) beside them
    xg = x.double().reshape(n, hw, groups, c // groups)
    var64 = xg.var(dim=(1, 3), unbiased=False)
    var_err = ((1 / rstd.double() ** 2 - 1e-5 - var64).abs() / var64).max().item()
    xf = x.float().reshape(n, hw, groups, c // groups)
    naive = xf.pow(2).mean(dim=(1, 3)) - xf.mean(dim=(1, 3)).pow(2)
    naive_var_err = ((naive.double() - var64).abs() / var64).max().item()

    def scaled(got, want, floor):
        diff = (got.float() - want.float()).abs()
        return diff.max().item(), (diff / want.float().abs().clamp(min=floor)).max().item()

    err, sc = scaled(y, ref, 1.0)
    label = f"N{n} HW{hw} C{c} G{groups} {act}{' film' if film else ''}{' mean100' if loc else ''}"
    assert math.isfinite(err) and sc <= TOL_GN[dtype] and var_err <= 1e-4, (
        f"group norm forward vs plain at {label} {dtype}: {sc} > {TOL_GN[dtype]} "
        f"(variance rel err {var_err})")
    dx_err, dx_sc = scaled(dx, rdx, rdx.float().pow(2).mean().sqrt().item())
    p_sc = max(scaled(got, want, want.pow(2).mean().sqrt().item())[1]
               for got, want in ((dgamma, rdgamma), (dbeta, rdbeta)))
    assert math.isfinite(dx_err) and dx_sc <= TOL_GN[dtype] and p_sc <= TOL_GN_PARAMS, (
        f"group norm backward vs plain at {label} {dtype}: dx {dx_sc}, params {p_sc}")
    del ref, rdx

    big = n * hw * c >= 2**24
    reps, preps = (20, 3) if big else (100, 20)
    fwd_ms = cuda_ms(lambda: G.group_norm_fwd_cuda(x, gamma, beta, groups, 1e-5, act), reps)
    bwd_ms = cuda_ms(lambda: G.group_norm_bwd_cuda(x, gamma, beta, mean, rstd, dy, groups,
                                                   act), reps)
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
    for direction, kms, pms, lms, e, s in (("fwd", fwd_ms, fwd_plain, lib_fwd, err, sc),
                                           ("bwd", bwd_ms, bwd_plain, lib_bwd, dx_err, dx_sc)):
        bound, by = gn_bound_ms(direction, act, n, hw, c, groups, esize)
        row = {"shape": label, "dtype": str(dtype).split(".")[-1], "max_abs_err": e,
               "max_scaled_err": s, "kernel_ms": kms, "plain_ms": pms, "library_ms": lms,
               "bound_ms": bound, "bound_by": by}
        if direction == "fwd":
            row.update(var_rel_err=var_err, naive_var_rel_err=naive_var_err)
        else:
            row["params_max_scaled_err"] = p_sc
        print(f"group_norm_{direction} " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


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
        model.set_impl(attn=impl, norm=impl).zero_grad(set_to_none=True)
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
    assert launched == expected(size, 1, 1), launched


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
    assert res["launches"] == expected(256, TRAIN_STEPS, TRAIN_STEPS), res["launches"]

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
    assert res["launches"] == expected(512, TRAIN_STEPS_512, TRAIN_STEPS_512), res["launches"]
    del res["state"]
    return res


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
    torch.save(randomize_parameters(UNet(cfg), seed).state_dict(), ckpt)
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
    # the forward as training runs it: with the lse, at the two main shapes
    lse_rows = [attention_case(8, 4096, 8, 48, torch.bfloat16, False, gen, with_lse=True),
                attention_case(8, 1024, 8, 64, torch.bfloat16, False, gen, with_lse=True)]
    rows += lse_rows

    bwd_rows = []
    for new_order in (False, True):  # training path: clouds UNet at 256 px, batch 8
        bwd_rows.append(attention_bwd_case(8, 4096, 8, 48, torch.bfloat16, new_order, gen))
    bwd_rows.append(attention_bwd_case(8, 1024, 8, 64, torch.bfloat16, False, gen))
    bwd_rows.append(attention_bwd_case(8, 256, 8, 48, torch.bfloat16, False, gen))  # 64 px
    bwd_rows.append(attention_bwd_case(8, 64, 8, 64, torch.bfloat16, False, gen))   # 64 px
    bwd_rows.append(attention_bwd_case(2, 1024, 8, 64, torch.float32, False, gen))  # --no_bf16
    bwd_rows.append(attention_bwd_case(3, 1000, 4, 48, torch.bfloat16, True, gen))  # ragged T
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
    ]
    torch.cuda.empty_cache()
    flash_bwd_rows = [
        flash_bwd_case(4, 16384, 8, 48, torch.bfloat16, "legacy", gen, hchunk=2),  # 512 px b4
        flash_bwd_case(1, 16384, 2, 48, torch.bfloat16, "new", gen, hchunk=2),
        flash_bwd_case(4, 2304, 8, 64, torch.bfloat16, "legacy", gen, hchunk=8),  # 384 px
        flash_bwd_case(2, 2309, 4, 48, torch.float32, "contiguous", gen, hchunk=4),
    ]
    torch.cuda.empty_cache()

    # GroupNorm + FiLM + SiLU, forward and backward: the clouds UNet's norm
    # sites at 256 px, batch 8 (levels 0-3; the attention norm has no SiLU;
    # 896 channels are groups of 28), then FiLM, a narrow width, f32 and the
    # mean-100 case where E[x^2] - E[x]^2 in f32 cancels
    gn_rows = []
    for n, hw, c, groups, act, dtype, film, loc in (
            (8, 65536, 128, 32, "silu", torch.bfloat16, False, 0.0),
            (8, 16384, 256, 32, "silu", torch.bfloat16, False, 0.0),
            (8, 4096, 384, 32, "none", torch.bfloat16, False, 0.0),
            (8, 1024, 512, 32, "silu", torch.bfloat16, False, 0.0),
            (8, 4096, 896, 32, "silu", torch.bfloat16, False, 0.0),
            (8, 4096, 384, 32, "silu", torch.bfloat16, True, 0.0),
            (8, 4096, 24, 24, "silu", torch.bfloat16, False, 0.0),
            (2, 16384, 256, 32, "silu", torch.float32, False, 0.0),
            (2, 65536, 128, 32, "silu", torch.float32, False, 100.0),
            (8, 262144, 128, 32, "silu", torch.bfloat16, False, 0.0)):  # 512 px, level 0
        gn_rows.append(gn_case(n, hw, c, groups, act, dtype, gen, film=film, loc=loc))
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

    # 8. the result lines
    main_row = rows[0]
    bwd_row = bwd_rows[0]
    gn_fwd_rows, gn_bwd_rows = [r[0] for r in gn_rows], [r[1] for r in gn_rows]
    kernels = [{
        "name": "qkv_attention_fwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_fwd.cu",
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
        "ms_with_lse": lse_rows[0]["kernel_ms"],
        "shapes": rows,
    }, {
        "name": "qkv_attention_bwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_bwd.cu",
        "replaces": "eo_diffusion_tpu/ops/attention.py:502",
        "launches": train_res["launches"]["attn_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["dtype"] == "bfloat16"),
        "ms": bwd_row["kernel_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "shapes": bwd_rows,
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_fwd.cu",
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
        "shapes": flash_rows,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_bwd.cu",
        "replaces": "eo_diffusion_tpu/ops/attention.py:502",
        "launches": train512["launches"]["flash_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_bwd_rows
                           if r["dtype"] == "bfloat16"),
        "ms": flash_bwd_rows[0]["kernel_ms"],
        "plain_ms": flash_bwd_rows[0]["plain_ms"],
        "bound_ms": flash_bwd_rows[0]["bound_ms"],
        "bound_by": flash_bwd_rows[0]["bound_by"],
        "library_ms": flash_bwd_rows[0]["library_ms"],
        "shapes": flash_bwd_rows,
    }] + [{
        "name": f"group_norm_{direction}",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/group_norm.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in gn if r["dtype"] == "bfloat16"),
        "ms": gn[0]["kernel_ms"],
        "plain_ms": gn[0]["plain_ms"],
        "bound_ms": gn[0]["bound_ms"],
        "bound_by": gn[0]["bound_by"],
        "library_ms": gn[0]["library_ms"],
        **extra,
        "shapes": gn,
    } for direction, replaces, launches, gn, extra in (
        ("fwd", "eo_diffusion_tpu/ops/group_norm.py:48", main_res["launches"]["gn_fwd"],
         gn_fwd_rows, {"launches_clouds64": res64["launches"]["gn_fwd"],
                       "launches_train": train_res["launches"]["gn_fwd"]}),
        ("bwd", "eo_diffusion_tpu/ops/group_norm.py:104", train_res["launches"]["gn_bwd"],
         gn_bwd_rows, {}))]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
