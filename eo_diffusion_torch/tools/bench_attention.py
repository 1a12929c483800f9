"""Time the attention kernel against another version of its source, on the GPU.

    git show <commit>:eo_diffusion_torch/ops/csrc/attention_fwd.cu > old.cu
    python -m eo_diffusion_torch.tools.bench_attention --against old.cu

Builds this checkout's kernel and the other source (same ``nvcc`` flags),
checks both against the plain version, and times them at the clouds UNet's
256 px shapes (batch 8, bf16) in alternating order (this, other, other,
this, ...) on one card, with CUDA events after warm-up. Prints one JSON line
with every run and the medians.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
from pathlib import Path

import torch

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops import attention as A

SHAPES = ((8, 4096, 8, 48), (8, 1024, 8, 64))  # (B, T, heads, D): ds 4 and ds 8
TOL = 2e-2  # bf16: |kernel - plain| / max(1, |plain|)


def _build_other(src: Path) -> ctypes.CDLL:
    digest = hashlib.sha256(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode())
    lib = _build.BUILD_DIR / f"libother_{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _ms(qkv, heads, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        A.qkv_attention_cuda(qkv, heads)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, help="another attention_fwd.cu")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: needs a CUDA device")
    libs = {"this": _build.load("attention_fwd"), "other": _build_other(Path(args.against))}

    def use(name):  # route the wrapper's launches to one library
        _build._loaded["attention_fwd"] = libs[name]

    g = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip(), "shapes": []}
    for b, t, heads, d in SHAPES:
        qkv = torch.randn(b, t, 3 * heads * d, generator=g, device="cuda").to(torch.bfloat16)
        ref = A.attention_from_qkv(qkv, heads, impl="plain").float()
        row = {"shape": f"B{b} T{t} H{heads} D{d}"}
        for name in libs:
            use(name)
            err = ((A.qkv_attention_cuda(qkv, heads).float() - ref).abs()
                   / ref.abs().clamp(min=1.0)).max().item()
            assert err <= TOL, (name, row["shape"], err)
            row[f"{name}_err"] = err
            _ms(qkv, heads, 3)  # warm-up
        runs = {"this": [], "other": []}
        for i in range(args.pairs):
            order = ("this", "other") if i % 2 == 0 else ("other", "this")
            for name in order:
                use(name)
                runs[name].append(_ms(qkv, heads, args.reps))
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
