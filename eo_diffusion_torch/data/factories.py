"""Dataloader factories (the sampling slice's part of ``eo_diffusion_tpu/data/factories.py``).

Only the data-free synthetic fixture is ported so far; the real EO datasets
(Inria, clouds, OSCD, EuroSAT, SEN12MS-CR, ...) come with the data slice.
"""

from __future__ import annotations

from eo_diffusion_torch.data.datasets import SyntheticEO, train_val_split
from eo_diffusion_torch.data.loader import DataLoader

__all__ = ["create_synthetic_dataloaders", "DATASET_FACTORIES"]


def create_synthetic_dataloaders(batch_size, image_size=64, length=1024, channels=3,
                                 val_split=0.15, SEED=4097, num_classes=5,
                                 data_range=(0.0, 1.0), with_cond_image=False, seed=0):
    """``(train_loader, test_loader)`` over :class:`SyntheticEO` with the
    reference's 0.15 val split and split seed 4097; the train loader flips."""
    ds = SyntheticEO(size=image_size, length=length, channels=channels,
                     num_classes=num_classes, data_range=data_range,
                     with_cond_image=with_cond_image)
    train_ds, test_ds = train_val_split(ds, val_split, SEED)
    return (DataLoader(train_ds, batch_size, shuffle=True, seed=seed, flips=True),
            DataLoader(test_ds, batch_size, shuffle=False, seed=seed, drop_last=False))


DATASET_FACTORIES = {"synthetic": create_synthetic_dataloaders}
