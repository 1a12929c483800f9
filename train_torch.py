#!/usr/bin/env python
"""Root entry point of the PyTorch port: ``python train_torch.py ...``.

Thin shim over :mod:`eo_diffusion_torch.cli.train` (the flags of the root
``train.py``, plus ``--device``; it trains on the GPU unless given
``--device cpu``).
"""

from eo_diffusion_torch.cli.train import main, parse_args

if __name__ == "__main__":
    main(parse_args())
