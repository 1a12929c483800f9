"""What the port's demos share: the device, and a checkpoint into a model.

Imported by the demos beside it; they put the repository root on
``sys.path`` first.
"""

import os

import torch

# ``name`` as a device (a CUDA device that is not there exits non-zero: the
# demos run on the GPU unless asked for the CPU), TF32 off, as the CLIs have it
from eo_diffusion_torch.cli.common import resolve_device  # noqa: F401


def load_weights(model: torch.nn.Module, path: str, cfg) -> None:
    """Load a reference ``.pt`` or a training checkpoint of the port (its EMA
    weights first) into ``model``. A JAX checkpoint (an orbax directory) is
    converted first with ``tools/jax_ckpt_to_torch.py``."""
    from eo_diffusion_torch.weights import load_reference_checkpoint

    if os.path.isdir(path):
        raise SystemExit(f"{path} is a directory (a JAX orbax checkpoint?); convert it with "
                         "tools/jax_ckpt_to_torch.py and pass the file it writes")
    model.load_state_dict(load_reference_checkpoint(path, cfg), strict=True)
    print(f"loaded {path}")
