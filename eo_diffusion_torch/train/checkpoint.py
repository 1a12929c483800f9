"""Checkpoints of the training state on ``torch.save``.

Counterpart of ``eo_diffusion_tpu/train/checkpoint.py`` (Orbax there). A
checkpoint is one file ``<ckpt_dir>/steps_<step:08d>`` (or a name such as
``best``) holding ``{"model", "model_ema", "opt_state", "step", ...}``:
``"model"`` and ``"model_ema"`` are the reference's own keys
(train.py:137-138) with the UNet's state-dict names, so
``weights.load_reference_checkpoint`` and the sampling CLI read a training
checkpoint as they read a reference ``.pt``, EMA weights first. Optimizer
state, step counter and the accumulation / skip-nonfinite counters ride
along, so resume continues the LR schedule, Adam's moments and the EMA
cadence exactly.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_params", "latest_step",
           "best_dir", "CheckpointManager"]

_STEP_PREFIX = "steps_"


def _step_name(step: int) -> str:
    return f"{_STEP_PREFIX}{step:08d}"


def save_checkpoint(ckpt_dir: str, state: Mapping[str, Any], step: Optional[int] = None,
                    name: Optional[str] = None) -> str:
    """Save a state mapping (``TrainState.state_dict()``) under
    ``ckpt_dir/steps_<step>`` (or ``name``). Written to a temporary file and
    renamed, so an interrupted save leaves the previous checkpoint intact."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name if name is not None else _step_name(step))
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(dict(state), tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d[len(_STEP_PREFIX):]) for d in os.listdir(ckpt_dir)
             if d.startswith(_STEP_PREFIX) and d[len(_STEP_PREFIX):].isdigit()]
    return max(steps) if steps else None


def best_dir(ckpt_dir: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), "best")


def restore_checkpoint(path: str, template=None):
    """Load what :func:`save_checkpoint` wrote. With a ``template`` (a
    ``TrainState``) the values are loaded into it, on its device, and it is
    returned; without one the raw mapping comes back on the CPU."""
    raw = torch.load(os.path.abspath(path), map_location="cpu", weights_only=False)
    if template is None:
        return raw
    template.load_state_dict(raw)
    return template


def restore_params(path: str) -> tuple:
    """Only ``(model, model_ema)`` state dicts of a training checkpoint;
    sampling needs no optimizer state."""
    raw = restore_checkpoint(path)
    return raw["model"], raw["model_ema"]


class CheckpointManager:
    """Periodic step checkpoints with retention: keeps at most
    ``max_to_keep`` ``steps_*`` files (named saves like ``best`` are never
    pruned)."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.ckpt_dir, self.max_to_keep = os.path.abspath(ckpt_dir), max_to_keep

    def steps(self):
        if not os.path.isdir(self.ckpt_dir):
            return []
        return sorted(int(d[len(_STEP_PREFIX):]) for d in os.listdir(self.ckpt_dir)
                      if d.startswith(_STEP_PREFIX) and d[len(_STEP_PREFIX):].isdigit())

    def save(self, step: int, state: Mapping[str, Any]) -> str:
        path = save_checkpoint(self.ckpt_dir, state, step=step)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.ckpt_dir, _step_name(old)))
        return path

    def restore_latest(self, template=None):
        steps = self.steps()
        if not steps:
            return None
        return restore_checkpoint(os.path.join(self.ckpt_dir, _step_name(steps[-1])), template)
