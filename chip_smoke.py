"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

1. require CUDA; print the card's name and power limit; TF32 off;
2. build every CUDA kernel of the port from the sources in this checkout;
3. hold each kernel (attention forward, attention backward) against its
   plain PyTorch version on the card at the shapes the main paths give it,
   and time kernel, plain version, the PyTorch library call and the card's
   lower bound;
4. one clouds-UNet forward at 256 px, kernel attention against plain, then
   one loss and backward, kernel against plain: every parameter gets a
   finite gradient, the attention's qkv weights a non-zero one;
5. the sampling path through the entry point: ``eo_diffusion_torch.cli.inference``
   with ``sen12mscr256`` (concat cloud removal), DDIM-50, batch 8, seeded
   random weights; the kernel counter must rise by 11 x 50 per batch;
6. the reference's own 64 px path: ``clouds64-attn`` RePaint DDPM-100;
7. the training path through the entry point: ``eo_diffusion_torch.cli.train``
   with ``sen12mscr256`` at full width and depth, batch 8, bf16, a few
   steps from seeded weights; both kernel counters must rise by 11 a step;
   the checkpoint restores and the sampling entry point samples from it;
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
from eo_diffusion_torch.models.unet import AttentionBlock, UNet, unet_clouds
from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
from eo_diffusion_torch.ops import attention as A
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
ATTN_PER_FORWARD = 11  # clouds UNet: 5 attention blocks at ds 4, 6 at ds 8
TRAIN_STEPS = 8


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


def unet_backward_check(model, gen):
    """One loss and backward of the 256 px UNet with the kernels against the
    plain attention: same weights, same batch, same timesteps and noise."""
    diffusion = GaussianDiffusion.create(timesteps=1000, image_size=256)
    x0 = torch.randn(2, 256, 256, 3, generator=gen, device="cuda")
    noise = torch.randn(2, 256, 256, 3, generator=gen, device="cuda")
    ts = torch.tensor([10, 500], device="cuda")
    model_fn = lambda x, t, c, y: model(x, t)
    grads, losses, counts = {}, {}, None
    for impl in ("auto", "plain"):
        for m in model.modules():
            if isinstance(m, AttentionBlock):
                m.attn_impl = impl
        model.zero_grad(set_to_none=True)
        A.qkv_attention_cuda.launches = A.qkv_attention_bwd_cuda.launches = 0
        loss = diffusion.train_loss(model_fn, x0, t=ts, noise=noise)
        loss.backward()
        torch.cuda.synchronize()
        if impl == "auto":
            counts = (A.qkv_attention_cuda.launches, A.qkv_attention_bwd_cuda.launches)
        else:
            assert A.qkv_attention_cuda.launches == A.qkv_attention_bwd_cuda.launches == 0
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
    print(f"unet256 loss+backward: loss {losses['auto']:.6f} (plain {losses['plain']:.6f}), "
          f"{len(grads['auto'])} parameter gradients finite, rel L2 kernel vs plain "
          f"{rel:.3e} (tol {TOL_UNET_GRAD_REL}), launches fwd {counts[0]} bwd {counts[1]}",
          flush=True)
    assert rel <= TOL_UNET_GRAD_REL, rel
    assert counts == (ATTN_PER_FORWARD, ATTN_PER_FORWARD), counts


def run_train(tmp, seed):
    """The training entry point at sen12mscr256 width and depth, then a
    restore of its checkpoint and a short sampling run from it."""
    argv = ["--preset", "sen12mscr256", "--dataset", "synthetic", "--batch_size", "8",
            "--epochs", "1", "--steps_per_epoch", str(TRAIN_STEPS), "--sample_every", "0",
            "--save_every", "0", "--model_ema_steps", "2", "--log_freq", "1",
            "--seed", str(seed), "--device", "cuda", "--dir", "results/train_smoke"]
    torch.cuda.reset_peak_memory_stats()
    A.qkv_attention_cuda.launches = A.qkv_attention_bwd_cuda.launches = 0
    with contextlib.chdir(tmp):  # the CLI writes logs/ and results/ under the cwd
        res = cli_train.main(cli_train.parse_args(argv))
    res["fwd_launches"] = A.qkv_attention_cuda.launches
    res["bwd_launches"] = A.qkv_attention_bwd_cuda.launches
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    assert res["steps"] == TRAIN_STEPS and len(res["losses"]) == TRAIN_STEPS, res["steps"]
    assert all(math.isfinite(x) for x in res["losses"]), res["losses"]
    want = ATTN_PER_FORWARD * TRAIN_STEPS
    assert (res["fwd_launches"], res["bwd_launches"]) == (want, want), (
        res["fwd_launches"], res["bwd_launches"], want)

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
    A.qkv_attention_cuda.launches = 0
    sampled = cli.main(args)
    x = torch.as_tensor(sampled["samples"])
    assert x.shape == (2, 256, 256, 3) and bool(torch.isfinite(x).all()), x.shape
    assert A.qkv_attention_cuda.launches == ATTN_PER_FORWARD * 4, A.qkv_attention_cuda.launches
    del res["state"]
    return res


def run_cli(argv, cfg, seed, tmp):
    """Run the inference entry point in-process with seeded random weights
    (saved as a state dict and passed with --ckpt)."""
    ckpt = os.path.join(tmp, f"weights_{seed}.pt")
    torch.save(randomize_parameters(UNet(cfg), seed).state_dict(), ckpt)
    args = cli.parse_args(argv + ["--ckpt", ckpt, "--outdir", os.path.join(tmp, "out"),
                                  "--seed", str(seed)])
    torch.cuda.reset_peak_memory_stats()
    A.qkv_attention_cuda.launches = 0
    res = cli.main(args)
    res["launches"] = A.qkv_attention_cuda.launches
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

    # 4. UNet forward at 256 px: kernel against plain attention, same weights
    cfg = unet_clouds(256, dtype=torch.bfloat16)
    model = randomize_parameters(UNet(cfg), seed=1).cuda().eval()
    x = torch.randn(2, 256, 256, 3, generator=gen, device="cuda")
    ts = torch.tensor([10, 500], device="cuda")
    with torch.inference_mode():
        A.qkv_attention_cuda.launches = 0
        out_k = model(x, ts).float()
        fwd_launches = A.qkv_attention_cuda.launches
        for m in model.modules():
            if isinstance(m, AttentionBlock):
                m.attn_impl = "plain"
        out_p = model(x, ts).float()
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    print(f"unet256 forward: rel L2 kernel vs plain {rel:.3e} (tol {TOL_UNET_REL}), "
          f"max abs {(out_k - out_p).abs().max().item():.3e}, |out| rms "
          f"{out_p.pow(2).mean().sqrt().item():.3e}, launches {fwd_launches}", flush=True)
    assert torch.isfinite(out_k).all() and rel <= TOL_UNET_REL, rel
    assert fwd_launches == ATTN_PER_FORWARD, fwd_launches
    del out_k, out_p
    unet_backward_check(model.train(), gen)
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
        want = ATTN_PER_FORWARD * steps * main_res["batches"]
        assert main_res["launches"] == want, (main_res["launches"], want)
        print(f"main path sen12mscr256 DDIM-{steps} b8: {main_res['images']} images in "
              f"{main_res['sample_seconds']:.3f} s = "
              f"{main_res['images'] / main_res['sample_seconds']:.4f} img/s, "
              f"kernel launches {main_res['launches']}, peak memory "
              f"{main_res['peak_mem_gb']:.2f} GiB", flush=True)

        # 6. the reference's 64 px RePaint DDPM path
        t64 = 100
        res64 = run_cli(["--preset", "clouds64-attn", "--dataset", "synthetic",
                         "--sampler", "ddpm", "--timesteps", str(t64), "--batch_size", "8",
                         "--n_iter", "1", "--device", "cuda"],
                        get_preset("clouds64-attn").unet_config(), seed=3, tmp=tmp)
        assert res64["samples"].shape == (8, 64, 64, 3), res64["samples"].shape
        want64 = ATTN_PER_FORWARD * t64 * res64["batches"]
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
              f"launches fwd {train_res['fwd_launches']} bwd {train_res['bwd_launches']}; "
              f"|d params| {train_res['param_delta']:.4e} |d ema| {train_res['ema_delta']:.4e}; "
              f"peak memory {train_res['peak_mem_gb']:.2f} GiB; {card}", flush=True)

    # 8. the result lines
    main_row = rows[0]
    bwd_row = bwd_rows[0]
    kernels = [{
        "name": "qkv_attention_fwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_fwd.cu",
        "replaces": "eo_diffusion_tpu/ops/attention.py:738",
        "launches": main_res["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "launches_clouds64": res64["launches"],
        "launches_train": train_res["fwd_launches"],
        "ms_with_lse": lse_rows[0]["kernel_ms"],
        "shapes": rows,
    }, {
        "name": "qkv_attention_bwd",
        "route": "cuda",
        "source": "eo_diffusion_torch/ops/csrc/attention_bwd.cu",
        "replaces": "eo_diffusion_tpu/ops/attention.py:502",
        "launches": train_res["bwd_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["dtype"] == "bfloat16"),
        "ms": bwd_row["kernel_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "shapes": bwd_rows,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
