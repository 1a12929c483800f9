"""Profiling and tracing hooks (counterpart of
``eo_diffusion_tpu/utils/profiling.py``, on ``torch.profiler``).

* :func:`trace` -- a context manager around a ``torch.profiler`` capture
  (the CPU, and the card's kernels where there is one), written as a Chrome
  trace (``trace.json`` under the directory; chrome://tracing, Perfetto or
  TensorBoard's profile plugin read it); :func:`start_trace` is the same as
  a start / ``stop()`` pair, for a window that opens and closes inside a
  loop. Each training step of ``cli.train --profile_dir`` is a
  ``record_function`` span named :data:`STEP_SPAN`.
* :class:`StepTimer` -- wall-clock step timing that waits for the card at
  the end of each step (where the JAX package fetches a scalar), with
  steps/s and the model FLOPs utilisation against the card's peak.
* :func:`flops_of` -- the FLOPs of a call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``, for the MFU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["trace", "start_trace", "StepTimer", "flops_of", "sync", "STEP_SPAN",
           "TRACE_FILE", "PEAK_FLOPS"]

# the span of one training step in a trace
STEP_SPAN = "train_step"
TRACE_FILE = "trace.json"
# NVIDIA H100 SXM, dense bf16 on the tensor cores (its data sheet); the
# default of StepTimer.summary
PEAK_FLOPS = 989e12


def sync(x: Any = None) -> None:
    """Wait for the card: synchronise the device of the first tensor in
    ``x`` (a tensor, or a list / tuple / dict of them), or the current CUDA
    device when ``x`` is None and there is one. CPU tensors need nothing."""
    leaves = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else [x])
    dev = next((t.device for t in leaves if torch.is_tensor(t)), None)
    if dev is None and x is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Capture:
    """A running ``torch.profiler`` capture; :meth:`stop` ends it once and
    writes ``<log_dir>/trace.json``."""

    def __init__(self, log_dir: str):
        from torch.profiler import ProfilerActivity, profile

        self.log_dir = log_dir
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.path = None

    def stop(self) -> str:
        if self.path is None:
            sync()
            self.prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            self.path = os.path.join(self.log_dir, TRACE_FILE)
            self.prof.export_chrome_trace(self.path)
        return self.path


def start_trace(log_dir: str) -> _Capture:
    """Start a capture now; ``.stop()`` ends it and writes the trace."""
    return _Capture(log_dir)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace("runs/prof"): step(...)``."""
    cap = start_trace(log_dir)
    try:
        yield cap
    finally:
        cap.stop()


class StepTimer:
    """Rolling step timer: ``with timer.step(loss): ...``. Reports steps/s
    and, given the FLOPs of a step, TFLOP/s and the model FLOPs utilisation."""

    def __init__(self, flops_per_step: Optional[float] = None, window: int = 50):
        self.flops = flops_per_step
        self.window = window
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self, sync_on: Any = None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            sync(sync_on)
        self.times.append(time.perf_counter() - t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def mean_step_time(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self, peak_flops: float = PEAK_FLOPS) -> Dict[str, float]:
        """``peak_flops``: the card's rate for the step's work, by default the
        H100's dense bf16 989 TFLOP/s."""
        dt = self.mean_step_time
        out = {"step_time_s": dt, "steps_per_sec": 1.0 / dt if dt else 0.0}
        if self.flops:
            out["tflops_per_sec"] = self.flops / dt / 1e12 if dt else 0.0
            out["mfu"] = self.flops / dt / peak_flops if dt else 0.0
        return out


def flops_of(fn: Callable, *args, **kwargs) -> float:
    """The FLOPs of ``fn(*args, **kwargs)``, one call counted by
    ``FlopCounterMode`` (a matmul or convolution's multiply-adds as two
    operations each)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
