"""Measurement helpers shared by the port's probe tools: kernel times from
CUDA events, the card's name and power limit, and the card's least time for
a piece of work."""

from __future__ import annotations

import json
import subprocess

import torch

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 and int8 tensor
# cores, f32 without tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32-accurate products on the tensor cores: three TF32 products each at
# the dense TF32 peak (495 TFLOP/s), a third of it
PEAK_TF32X3 = 495e12 / 3


def cuda_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """Milliseconds a call of ``fn`` (CUDA events over ``reps`` calls after
    ``warmup``)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 100, warmup: int = 3) -> float:
    """Device milliseconds a call of ``fn`` when the host is not what waits:
    the timed calls are queued behind a spin of about a quarter second on the
    card, so their launch rate cannot starve it (``cuda_ms`` at a short
    kernel measures the host's launch rate as well)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(5e8))  # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternate_ms(what: str, shape: str, fns: dict, reps: int) -> dict:
    """Each of ``fns``' device ms (:func:`queued_ms`) in two rounds, the
    second in reverse order, and its ratio to ``fns["body"]``'s: for timing
    copies of a kernel's source against the source as built. Printed as one
    JSON line and returned."""
    ms = {n: [] for n in fns}
    for order in (list(fns), list(fns)[::-1]):
        for n in order:
            ms[n].append(queued_ms(fns[n], reps))
    row = {"what": what, "shape": shape, "device_ms": ms,
           "ratio": {n: sum(v) / sum(ms["body"]) for n, v in ms.items()}}
    print(json.dumps(row), flush=True)
    return row


def bound_ms(ops: float, peak: float, nbytes: float):
    """The card's least time for ``ops`` operations at ``peak`` per second and
    ``nbytes`` moved once at the memory rate: (ms, "operations" or "bytes")."""
    by_ops, by_bytes = ops / peak, nbytes / PEAK_BYTES_PER_S
    return max(by_ops, by_bytes) * 1e3, "operations" if by_ops >= by_bytes else "bytes"


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
