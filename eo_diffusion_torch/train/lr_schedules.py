"""Keyframe learning-rate schedules (the port's own copy of
``eo_diffusion_tpu/train/lr_schedules.py``, which is numpy only).

Re-design of the reference ``KeyframeLR`` torch scheduler
(``script_utils/train_utils.py:17-226``): a list of keyframes
``{"position": p, "lr": v}`` with named ("linear", "cos") or callable
transitions between them, in "percent", "steps", or "time" units
(train_utils.py:23 — "time" positions are fractions of an expected run time
in seconds, evaluated against the wall clock).

The schedule is parsed and evaluated host-side in pure Python and
materialized into a dense per-step float32 table (the reference only ever
evaluates the schedule at integer step positions, so the table is exact,
including for user-provided callable transitions). :func:`set_lr` writes
``table[clip(step)]`` into an optimizer's parameter groups once per
optimizer step; that takes the place of the JAX package's ``as_optax``.

``warmup_cos_exp`` reproduces the exact composite schedule the reference
builds in ``train.py:76-85`` (cos warmup from lr/100 to lr over
``10*steps_per_epoch`` steps, then exponential decay ``lr*exp(-3*frac)``).
"""

from __future__ import annotations

import math
from timeit import default_timer as _timer
from typing import Callable, Mapping, Sequence, Union

import numpy as np

__all__ = ["KeyframeSchedule", "warmup_cos_exp", "set_lr"]

Frame = Union[Mapping, Sequence, str, Callable]


class KeyframeSchedule:
    """Keyframe LR schedule with linear/cos/callable transitions.

    Frames follow the reference semantics (train_utils.py:64-118):

    * position frames: ``{"position": p, "lr": v}`` or shorthand ``(p, v)``;
      ``"position": "end"`` resolves to the final position.
    * transition frames between them: ``{"transition": "cos"}`` or shorthand
      ``"cos"`` / a callable ``f(last_lr, start_frame, end_frame, pos,
      scheduler) -> lr``. Missing transitions default to linear.
    * an implicit ``{"position": 0, "lr": 0}`` /
      ``{"position": end, "lr": 0}`` is inserted if the first/last frame
      doesn't pin the boundary.
    """

    def __init__(self, frames: Sequence[Frame], end: float, units: str = "percent"):
        assert units in ("percent", "steps", "time"), units
        self.end = end
        self.units = units
        self.last_lr = 0.0
        self.frames = self._parse(frames)
        # "time" units (train_utils.py:23,50-54,190-197): `end` is the
        # expected run time in SECONDS, positions are fractions of it, and
        # evaluation reads the wall clock — inherently host-side, so it
        # cannot be materialized into a step table (see table()).
        self.start_time = _timer() if units == "time" else None

    # -- parsing ------------------------------------------------------------

    def _parse(self, user_frames):
        end_pos = self.end if self.units == "steps" else 1

        unpacked = []
        for frame in user_frames:
            if isinstance(frame, (list, tuple)) and len(frame) == 2:
                frame = {"position": frame[0], "lr": frame[1]}
            if isinstance(frame, str) or callable(frame):
                frame = {"transition": frame}
            frame = dict(frame)
            if frame.get("position", None) == "end":
                frame["position"] = end_pos
            unpacked.append(frame)

        frames = []
        prev_pos = -1
        for i, frame in enumerate(unpacked):
            first, last = i == 0, i == len(unpacked) - 1
            if first:
                if "position" in frame and frame["position"] != 0:
                    frames += [{"position": 0, "lr": 0}, {"transition": "linear"}]
                if "transition" in frame:
                    frames.append({"position": 0, "lr": 0})
            frames.append(frame)
            if "position" in frame:
                pos = frame["position"]
                if not (prev_pos <= pos <= end_pos):
                    raise ValueError(f"keyframe position {pos} out of order/range")
                prev_pos = pos
                if not last and "position" in unpacked[i + 1]:
                    frames.append({"transition": "linear"})
            if last:
                if "position" in frame and frame["position"] < end_pos:
                    frames += [{"transition": "linear"}, {"position": end_pos, "lr": 0}]
                if "transition" in frame:
                    frames.append({"position": end_pos, "lr": 0})
        return frames

    # -- evaluation ----------------------------------------------------------

    @staticmethod
    def _lerp(a, b, pct):
        return (1 - pct) * a + pct * b

    def _interp(self, start, transition, endf, position):
        span = endf["position"] - start["position"]
        pct = (position - start["position"]) / span if span else 1.0
        if transition == "linear":
            return self._lerp(start["lr"], endf["lr"], pct)
        if transition == "cos":
            pct_cos = 1 - (1 + math.cos(pct * math.pi)) / 2
            return self._lerp(start["lr"], endf["lr"], pct_cos)
        if callable(transition):
            return transition(self.last_lr, start, endf, position, self)
        raise ValueError(f"Unknown transition: {transition!r}")

    def lr_at_position(self, position: float) -> float:
        start = transition = endf = lr = None
        for frame in self.frames:
            if "position" in frame:
                if frame["position"] == position:
                    lr = frame["lr"]
                    break
                if frame["position"] < position:
                    start = frame
            if start is not None and "transition" in frame:
                transition = frame["transition"]
            if transition is not None and frame.get("position", -1) >= position:
                endf = frame
                break
        if lr is None:
            if start is None or endf is None:
                return self.last_lr
            lr = self._interp(start, transition, endf, position)
        self.last_lr = lr
        return lr

    def __call__(self, step: int) -> float:
        self._last_step = step
        if self.units == "time":
            # step is ignored: position is elapsed-wall-time / expected-run-
            # time. Past the expected end, lr_at_position finds no bracketing
            # frames and holds last_lr (reference get_lr_at_pos fallthrough).
            return self.lr_at_position((_timer() - self.start_time) / self.end)
        pos = step / self.end if self.units == "percent" else step
        return self.lr_at_position(pos)

    @property
    def progress(self) -> float:
        """Fraction of the schedule consumed (train_utils.py:184-188); for
        "time" units this reads the wall clock, otherwise the last step
        seen by __call__ over `end`."""
        if self.units == "time":
            return (_timer() - self.start_time) / self.end
        return getattr(self, "_last_step", 0) / self.end

    def sample_lrs(self, n: int = 100):
        """Sample n LRs across the schedule for visualization
        (train_utils.py:204-222); works for every unit, including "time"
        (positions are fractions, no clock involved)."""
        lrs = []
        for i in range(n):
            pos = i / n
            if self.units == "steps":
                pos *= self.end
            lrs.append(self.lr_at_position(pos))
        self.last_lr = 0.0
        return lrs

    # -- dense table ---------------------------------------------------------

    def table(self, num_steps: int) -> np.ndarray:
        """Dense per-step LR table (exact at every integer step)."""
        if self.units == "time":
            raise ValueError(
                'units="time" evaluates against the wall clock and cannot '
                "be materialized into a step table — call the schedule "
                "host-side per step (see __call__), or use percent/steps "
                "units for the table path")
        self.last_lr = 0.0
        out = np.empty(num_steps, np.float32)
        for s in range(num_steps):
            out[s] = self(s)
        self.last_lr = 0.0
        return out


def set_lr(optimizer, table: np.ndarray, step: int) -> float:
    """Set every parameter group's ``lr`` to ``table[clip(step)]`` (``step``
    counts optimizer steps) and return it."""
    lr = float(table[min(max(int(step), 0), len(table) - 1)])
    for group in optimizer.param_groups:
        group["lr"] = lr
    return lr


def warmup_cos_exp(base_lr: float, steps_per_epoch: int, epochs: int,
                   warmup_epochs: int = 10, decay_rate: float = 3.0) -> KeyframeSchedule:
    """The exact composite schedule built by the reference trainer
    (train.py:76-85): cos warmup lr/100 -> lr over ``warmup_epochs`` epochs,
    then exponential decay ``lr * exp(-decay_rate * frac-of-remaining)``."""
    max_steps = steps_per_epoch * epochs
    posmax = warmup_epochs * steps_per_epoch

    def exp_tail(last_lr, sf, ef, pos, *_):
        return base_lr * math.exp(-decay_rate * (pos - posmax) / (max_steps - posmax))

    return KeyframeSchedule(
        frames=[
            {"position": 0, "lr": base_lr / 100},
            {"transition": "cos"},
            {"position": posmax, "lr": base_lr},
            {"transition": exp_tail},
        ],
        end=max_steps,
        units="steps",
    )
