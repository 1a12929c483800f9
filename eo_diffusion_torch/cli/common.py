"""What the port's command-line entry points share."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(name: str, program: str) -> torch.device:
    """``--device`` as a device. The entry points run on the card unless
    asked for the CPU, so a CUDA device that is not there exits non-zero,
    naming ``program``."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{program}: no CUDA device is available; pass --device cpu to run "
                         "on the CPU")
    return device
