#!/usr/bin/env python
"""Root entry point of the PyTorch port: ``python inference_torch.py ...``.

Thin shim over :mod:`eo_diffusion_torch.cli.inference` (the flags of the
root ``inference.py``, plus ``--device``; it samples on the GPU unless given
``--device cpu``).
"""

from eo_diffusion_torch.cli.inference import main, parse_args

if __name__ == "__main__":
    main(parse_args())
