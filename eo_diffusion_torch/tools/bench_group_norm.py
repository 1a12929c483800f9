"""Time the GroupNorm kernel over every norm site of a UNet forward, on the GPU.

    python -m eo_diffusion_torch.tools.bench_group_norm [--preset sen12mscr256]
        [--batch_size 8] [--image_size 512] [--against]

Runs one forward of the preset's UNet (seeded random weights, bf16) with a
hook on every ``GroupNorm32`` to collect the sites' shapes, activations and
FiLM use, then for each distinct site times, on the device alone (CUDA
events over calls queued behind a spin, ``timing.queued_ms``, so the host's
launch rate does not set the pace): the forward and backward kernels
(``group_norm_sm90.cu``, one launch a direction), ``F.group_norm`` (affine
``[C]``, no SiLU) with its backward on an NCHW-contiguous copy of the same
data, and their plain versions (back to back). With ``--against``, also
the old three-launch body (``group_norm.cu``) on the same tensors, in the
same run. Sums them over the forward's sites beside the bound (the bytes
each site must move at 3.35 TB/s: x read and y written once forward; x and
dy read and dx written once backward) and prints a per-site table.

Also reports the host's cost of one call (the time to enqueue it, no
synchronisation) for the kernel's wrapper (and the old body's with
``--against``), ``fused_group_norm`` and the plain version, and the whole
forward with the norms on the kernel and on the plain version, in turns
(kernel, plain, plain, kernel, ...). Prints one JSON line and writes it to
``--out`` as well.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import time
from collections import Counter

import torch
import torch.nn.functional as F

from eo_diffusion_torch.cli.presets import get_preset
from eo_diffusion_torch.models.unet import UNet
from eo_diffusion_torch.nn.primitives import GroupNorm32
from eo_diffusion_torch.ops import group_norm as G
from eo_diffusion_torch.tools.timing import queued_ms
from eo_diffusion_torch.weights import randomize_parameters

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def _ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, reps=200):
    """Microseconds to enqueue one call: the host's cost, the device left
    to run behind it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def collect_sites(model, *inputs):
    """One forward; returns a Counter of (x shape [N, HW, C], dtype, groups,
    act, film) over the model's GroupNorm32 calls."""
    sites = Counter()

    def hook(mod, args, kwargs, out):
        x = args[0]
        sites[((x.shape[0], x[0, ..., 0].numel(), x.shape[-1]), x.dtype, mod.groups,
               kwargs.get("act", "none"), kwargs.get("scale") is not None)] += 1

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in model.modules() if isinstance(m, GroupNorm32)]
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return sites


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="sen12mscr256")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--image_size", type=int, default=None, help="default: the preset's")
    ap.add_argument("--against", action="store_true",
                    help="also time the old three-launch body (group_norm.cu)")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/bench_group_norm.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_group_norm: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)

    preset = get_preset(args.preset)
    cfg = preset.unet_config(**({"cond_channels": preset.in_channels}
                                if preset.cond_type == "concat" else {}))
    if args.image_size:
        cfg = dataclasses.replace(cfg, image_size=args.image_size)
    model = randomize_parameters(UNet(cfg), args.seed).to(dev).eval()
    n, s = args.batch_size, cfg.image_size
    x_in = torch.randn(n, s, s, cfg.in_channels, generator=g, device=dev).to(cfg.dtype)
    t_in = torch.full((n,), 500, device=dev, dtype=torch.long)
    sites = collect_sites(model, x_in, t_in)

    rows, totals = [], Counter()
    for (shape, dtype, groups, act, film), count in sorted(sites.items(), key=str):
        nn_, hw, c = shape
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        dy = torch.randn(shape, generator=g, device=dev).to(dtype)
        w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        b = 0.1 * torch.randn(c, generator=g, device=dev)
        gamma, beta = w.expand(nn_, c).contiguous(), b.expand(nn_, c).contiguous()
        y, mean, rstd = G.group_norm_fwd_cuda(x, gamma, beta, groups, act=act)
        reps = 20 if x.numel() >= 2**24 else 100
        plan = G._card_plan("fwd", x, *shape, groups)[0]
        row = {"shape": list(shape), "groups": groups, "act": act, "film": film,
               "dtype": str(dtype).split(".")[-1], "count": count,
               "plan_fwd": [plan.mode, plan.teams, plan.blocks, plan.held_rows, plan.chunk_rows],
               "kernel_fwd_ms": queued_ms(lambda: G.group_norm_fwd_cuda(x, gamma, beta, groups,
                                                                        act=act), reps),
               "kernel_bwd_ms": queued_ms(lambda: G.group_norm_bwd_cuda(
                   x, gamma, beta, mean, rstd, dy, groups, act), reps),
               "plain_fwd_ms": _ms(lambda: G.group_norm_reference(x, gamma, beta, groups,
                                                                  act=act), 5),
               "plain_bwd_ms": _ms(lambda: G.group_norm_backward_reference(
                   x, gamma, beta, mean, rstd, dy, groups, act), 5)}
        if args.against:
            row["old_fwd_ms"] = queued_ms(lambda: G.group_norm_fwd_legacy_cuda(
                x, gamma, beta, groups, act=act), reps)
            row["old_bwd_ms"] = queued_ms(lambda: G.group_norm_bwd_legacy_cuda(
                x, gamma, beta, mean, rstd, dy, groups, act), reps)
        xl = x.permute(0, 2, 1).contiguous().requires_grad_()
        wl, bl = (v.to(dtype).requires_grad_() for v in (w, b))
        yl = F.group_norm(xl, groups, wl, bl, 1e-5)
        dyl = dy.permute(0, 2, 1).contiguous()
        row["library_fwd_ms"] = queued_ms(lambda: F.group_norm(xl.detach(), groups, wl.detach(),
                                                               bl.detach(), 1e-5), reps)
        row["library_bwd_ms"] = queued_ms(lambda: torch.autograd.grad(
            yl, (xl, wl, bl), dyl, retain_graph=True), reps)
        nbytes = x.numel() * x.element_size()
        row["bound_fwd_ms"] = 2 * nbytes / PEAK_BYTES_PER_S * 1e3
        row["bound_bwd_ms"] = 3 * nbytes / PEAK_BYTES_PER_S * 1e3
        for k, v in row.items():
            if k.endswith("_ms"):
                totals[k] += count * v
        rows.append(row)
        del x, dy, y, xl, yl, dyl

    # the host's cost of one call, at the level-3 shape (small on the device)
    x = torch.randn(n, 1024, 512, generator=g, device=dev).to(cfg.dtype)
    w, b = torch.ones(512, device=dev), torch.zeros(512, device=dev)
    gamma, beta = w.expand(n, 512).contiguous(), b.expand(n, 512).contiguous()
    with torch.inference_mode():
        host = {"wrapper": _host_us(lambda: G.group_norm_fwd_cuda(x, gamma, beta, 32, act="silu")),
                **({"old_body_wrapper": _host_us(lambda: G.group_norm_fwd_legacy_cuda(
                    x, gamma, beta, 32, act="silu"))} if args.against else {}),
                "fused_group_norm": _host_us(lambda: G.fused_group_norm(x, w, b, 32, act="silu")),
                "plain": _host_us(lambda: G.fused_group_norm(x, w, b, 32, act="silu",
                                                             impl="plain"))}

        # the forward, norms on the kernel against norms plain, in turns
        fwd = {"auto": [], "plain": []}
        for i in range(args.pairs):
            for impl in (("auto", "plain") if i % 2 == 0 else ("plain", "auto")):
                model.set_impl(norm=impl)
                model(x_in, t_in)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    model(x_in, t_in)
                torch.cuda.synchronize()
                fwd[impl].append((time.perf_counter() - t0) * 1e3 / 3)
        model.set_impl(norm="auto")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    cols = ["kernel_fwd_ms", "kernel_bwd_ms"] + (["old_fwd_ms", "old_bwd_ms"]
                                                 if args.against else []) + [
        "bound_fwd_ms", "bound_bwd_ms", "library_fwd_ms", "library_bwd_ms"]
    print("site x count | " + " | ".join(cols))
    for r in rows + [{"shape": "sum", "count": sum(sites.values()), **totals}]:
        print(f"{r['shape']} x {r['count']} | " + " | ".join(f"{r[k]:.5g}" for k in cols))
    res = {"card": card.strip(), "preset": args.preset, "batch_size": n,
           "image_size": cfg.image_size,
           "sites": sum(sites.values()),
           "per_forward_ms": dict(totals),
           "host_us_per_call": host,
           "forward_ms_norms_kernel": fwd["auto"], "forward_ms_norms_plain": fwd["plain"],
           "forward_ms_median": {k: statistics.median(v) for k, v in fwd.items()},
           "rows": rows}
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
