"""Time the attention kernels on the GPU.

    git show <commit>:eo_diffusion_torch/ops/csrc/attention_fwd_sm90.cu > old.cu
    git show <commit>:eo_diffusion_torch/ops/csrc/attention_bwd_sm90.cu > old_bwd.cu
    python -m eo_diffusion_torch.tools.bench_attention --against old.cu
    python -m eo_diffusion_torch.tools.bench_attention --kernel bwd --against old_bwd.cu
    python -m eo_diffusion_torch.tools.bench_attention --kernel flash

``--kernel fwd`` / ``bwd``: builds this checkout's kernel (the fused-qkv
entries' bf16 bodies ``attention_fwd_sm90.cu`` or ``attention_bwd_sm90.cu``) and the
other source (same ``nvcc`` flags, ``csrc/`` on the include path), checks
both against the plain version and whether they give the same bits, and
times them at the clouds UNet's 256 px
shapes (batch 8, bf16) in alternating order (this, other, other, this, ...)
on one card, with CUDA events after warm-up. Prints one JSON line with every
run and the medians.

``--kernel flash``: the separate-tensor entries, forward and backward, on
the ``split_qkv`` views the UNet hands them at 384 and 512 px (batch 8,
bf16), beside ``F.scaled_dot_product_attention`` (forward, and its backward
alone) on contiguous ``[B, H, T, D]`` copies of the same tensors and the
card's lower bound, max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s). Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import statistics
import subprocess
from pathlib import Path

import torch

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops import attention as A

SHAPES = ((8, 4096, 8, 48), (8, 1024, 8, 64))  # (B, T, heads, D): ds 4 and ds 8
# the separate-tensor route: ds 4 at 512 px, ds 4 and ds 8 at 384 px
FLASH_SHAPES = ((8, 16384, 8, 48), (8, 9216, 8, 48), (8, 2304, 8, 64))
PEAK_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12  # H100 SXM: dense bf16, HBM3
TOL = 2e-2  # forward, bf16: |kernel - plain| / max(1, |plain|)
TOL_BWD = 4e-2  # backward, bf16: |kernel - plain| / max(rms of the gradient, |plain|)


def _build_other(src: Path) -> ctypes.CDLL:
    digest = hashlib.sha256(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode())
    lib = _build.BUILD_DIR / f"libother_{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC),
                        "-o", str(lib), str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3


def flash(reps: int) -> dict:
    """The separate-tensor entries against SDPA and the bound."""
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": _card(), "shapes": []}
    for b, t, heads, d in FLASH_SHAPES:
        qkv = torch.randn(b, t, 3 * heads * d, generator=g, device="cuda").to(torch.bfloat16)
        q, k, v = A.split_qkv(qkv, heads)
        out, lse = A.flash_attention_cuda(q, k, v, return_lse=True)
        dout = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
        q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous().requires_grad_() for x in (q, k, v))
        o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                              scale=1.0 / math.sqrt(d))
        g4 = dout.permute(0, 2, 1, 3).contiguous()
        runs = {
            "fwd_ms": lambda: A.flash_attention_cuda(q, k, v),
            "fwd_lse_ms": lambda: A.flash_attention_cuda(q, k, v, return_lse=True),
            "bwd_ms": lambda: A.flash_attention_bwd_cuda(q, k, v, out, lse, dout),
            "sdpa_fwd_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                q4.detach(), k4.detach(), v4.detach(), scale=1.0 / math.sqrt(d)),
            "sdpa_bwd_ms": lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True),
        }
        row = {"shape": f"B{b} T{t} H{heads} D{d}"}
        for name, fn in runs.items():
            _ms(fn, 2)  # warm-up
            row[name] = _ms(fn, reps)
        flops, esize = 4.0 * b * heads * t * t * d, 2
        row["fwd_bound_ms"] = _bound_ms(flops, esize * b * t * heads * d * 4)
        row["bwd_bound_ms"] = _bound_ms(2.5 * flops,
                                        esize * b * t * heads * d * 8 + 4 * b * heads * t)
        row["fwd_over_bound"] = row["fwd_ms"] / row["fwd_bound_ms"]
        row["bwd_over_bound"] = row["bwd_ms"] / row["bwd_bound_ms"]
        res["shapes"].append(row)
        del qkv, q, k, v, out, lse, dout, q4, k4, v4, o4, g4
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another version of the kernel's .cu (fwd, bwd)")
    ap.add_argument("--kernel", choices=["fwd", "bwd", "flash"], default="fwd")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: needs a CUDA device")
    if args.kernel == "flash":
        return flash(args.reps)
    if args.against is None:
        ap.error("--kernel fwd/bwd needs --against")
    kernel = {"fwd": "attention_fwd_sm90", "bwd": "attention_bwd_sm90"}[args.kernel]
    libs = {"this": _build.load(kernel), "other": _build_other(Path(args.against))}

    def use(name):  # route the wrapper's launches to one library
        _build._loaded[kernel] = libs[name]

    g = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": _card(), "shapes": []}
    for b, t, heads, d in SHAPES:
        qkv = torch.randn(b, t, 3 * heads * d, generator=g, device="cuda").to(torch.bfloat16)
        if args.kernel == "fwd":
            run = lambda: A.qkv_attention_cuda(qkv, heads)
            ref = A.attention_from_qkv(qkv, heads, impl="plain").float()
            floor, tol = 1.0, TOL
        else:
            out, lse = A.qkv_attention_cuda(qkv, heads, return_lse=True)
            dout = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
            run = lambda: A.qkv_attention_bwd_cuda(qkv, out, lse, dout, heads)
            shape = (b, t, heads, d)
            ref = A.stack_qkv(*A.reference_attention_bwd(
                *A.split_qkv(qkv, heads), out.reshape(shape), lse, dout.reshape(shape))).float()
            floor, tol = ref.pow(2).mean().sqrt().item(), TOL_BWD
        row = {"shape": f"B{b} T{t} H{heads} D{d}"}
        outs = {}
        for name in libs:
            use(name)
            outs[name] = run()
            err = ((outs[name].float() - ref).abs() / ref.abs().clamp(min=floor)).max().item()
            assert err <= tol, (name, row["shape"], err)
            row[f"{name}_err"] = err
            _ms(run, 3)  # warm-up
        row["same_bits"] = torch.equal(outs["this"], outs["other"])
        del ref, outs
        runs = {"this": [], "other": []}
        for i in range(args.pairs):
            order = ("this", "other") if i % 2 == 0 else ("other", "this")
            for name in order:
                use(name)
                runs[name].append(_ms(run, args.reps))
        for name, ms in runs.items():
            row[f"{name}_ms"] = ms
            row[f"{name}_median_ms"] = statistics.median(ms)
        row["this_wins"] = sum(a < o for a, o in zip(runs["this"], runs["other"]))
        res["shapes"].append(row)
    use("this")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
