"""Dataloader factory functions with the reference's API surface.

The port's copy of the JAX package's ``data/factories.py``, mirroring
``data_utils/data.py:24-122``'s ``create_*_dataloaders`` family: each
returns ``(train_loader, test_loader)`` of dict batches, with the same
augmentation stacks, val-split fraction (0.15) and split seed (4097). Roots
default to the reference's relative paths but every factory takes ``root=``.
``DATASET_FACTORIES`` is the registry the CLIs select from.
"""

from __future__ import annotations

from eo_diffusion_torch.data import transforms as T
from eo_diffusion_torch.data.datasets import (
    CIFAR10Dataset,
    CloudMaskDataset,
    Dataset,
    EuroSATDataset,
    InriaDataset,
    MNISTDataset,
    OSCDDataset,
    SARWakeDataset,
    SyntheticEO,
    SyntheticEOHard,
    train_val_split,
)
from eo_diffusion_torch.data.loader import DataLoader

__all__ = [
    "create_mnist_dataloaders",
    "create_cifar10_dataloaders",
    "create_inria_dataloaders",
    "create_cloud_dataloaders",
    "create_oscd_dataloaders",
    "create_SARWake_dataloaders",
    "create_Eurosat_dataloaders",
    "create_synthetic_dataloaders",
    "create_synthetic_hard_dataloaders",
    "DATASET_FACTORIES",
]


def _loaders(train_ds, test_ds, batch_size, transforms=None, seed=0, shard=(0, 1),
             num_workers=0, prefetch=2):
    train = DataLoader(train_ds, batch_size, shuffle=True, seed=seed,
                       transforms=transforms, shard=shard,
                       num_workers=num_workers, prefetch=prefetch)
    test = DataLoader(test_ds, batch_size, shuffle=False, seed=seed, shard=shard,
                      drop_last=False, num_workers=num_workers, prefetch=prefetch)
    return train, test


# flip-pair augmentation used by inria/cloud/eurosat (data.py:66-67, 81, 115)
_FLIPS = T.Compose([T.RandomHorizontalFlip(), T.RandomVerticalFlip()])
# sharpness/solarize stack used by oscd/sarwake (data.py:91-94, 105-108);
# Normalize(0.5,0.5) shifts to [-1,1]
def _oscd_augs(img_channels=3):
    return T.Compose([
        T.RandomHorizontalFlip(), T.RandomHorizontalFlip(),
        T.RandomAdjustSharpness(0.3, p=0.3, img_channels=img_channels),
        T.RandomSolarize(0.5, p=0.1, img_channels=img_channels),
        T.RandomAdjustSharpness(1.5, p=0.3, img_channels=img_channels),
        T.Normalize(0.5, 0.5, img_channels=img_channels),
    ])


def create_mnist_dataloaders(batch_size, image_size=28, num_workers=4, root="../data/mnist_data",
                             return_dataset=False, **kw):
    train = MNISTDataset(root, train=True, image_size=image_size)
    test = MNISTDataset(root, train=False, image_size=image_size)
    if return_dataset:
        return train, test
    return _loaders(train, test, batch_size, num_workers=num_workers, **kw)


def create_cifar10_dataloaders(batch_size, image_size=32, num_workers=4, root="./cifar_data",
                               return_dataset=False, **kw):
    train, test = CIFAR10Dataset(root, True), CIFAR10Dataset(root, False)
    if return_dataset:
        return train, test
    aug = T.Compose([T.RandomHorizontalFlip()])
    return _loaders(train, test, batch_size, transforms=aug,
                    num_workers=num_workers, **kw)


def create_inria_dataloaders(batch_size, image_size=64, patch_overlap=0.5, num_workers=0,
                             val_split=0.15, SEED=4097, test=False, length=3,
                             num_patches=200, root="../EO-Diffusion/data/AerialImageDataset",
                             return_dataset=False, **kw):
    ds = InriaDataset(root, size=image_size, patch_overlap=patch_overlap,
                      num_patches=num_patches, length=length)
    train_ds, test_ds = train_val_split(ds, val_split, SEED)
    if return_dataset:
        return train_ds, test_ds
    return _loaders(train_ds, test_ds, batch_size, num_workers=num_workers,
                    transforms=None if test else _FLIPS, **kw)


def create_cloud_dataloaders(batch_size, num_workers=0, val_split=0.15, SEED=4097,
                             return_dataset=False, test=False,
                             root="../data/Sentinel-2-CMC", **kw):
    ds = CloudMaskDataset(root, **{k: v for k, v in kw.items()
                                   if k in ("classes", "percents", "size", "num_patches", "ratio", "length")})
    train_ds, test_ds = train_val_split(ds, val_split, SEED)
    if return_dataset:
        return train_ds, test_ds
    return _loaders(train_ds, test_ds, batch_size, num_workers=num_workers,
                    transforms=None if test else _FLIPS)


def create_oscd_dataloaders(batch_size, num_workers=0, val_split=0.15, SEED=4097,
                            return_dataset=False, test=False, fake=False,
                            root="../data", pw=64, sw=32, **kw):
    import os

    if fake:
        path = OSCDDataset.fake_dirname(root, pw=pw, sw=sw, **{k: v for k, v in kw.items()
                                        if k in ("ph", "sh", "mnh", "mnw", "mxw", "mxh", "clip", "mult")})
        ds = OSCDDataset(path, length=kw.get("length"))
        train_ds, test_ds = train_val_split(ds, val_split, SEED)
    else:
        base = os.path.join(root, f"OSCD_{pw}_{sw}")
        train_ds = OSCDDataset(os.path.join(base, "train"), length=kw.get("length"))
        test_ds = OSCDDataset(os.path.join(base, "test"), length=kw.get("length"))
    if return_dataset:
        return train_ds, test_ds
    return _loaders(train_ds, test_ds, batch_size, num_workers=num_workers,
                    transforms=None if test else _oscd_augs())


def create_SARWake_dataloaders(batch_size, num_workers=0, val_split=0.15, SEED=4097,
                               return_dataset=False, test=False, root="../data/SARWake", **kw):
    train_ds = SARWakeDataset(root, mode="train", **kw)
    test_ds = SARWakeDataset(root, mode="val", **kw)
    if return_dataset:
        return train_ds, test_ds
    return _loaders(train_ds, test_ds, batch_size, num_workers=num_workers,
                    transforms=None if test else _oscd_augs(img_channels=1))


def create_Eurosat_dataloaders(batch_size, num_workers=0, val_split=0.15, SEED=4097,
                               return_dataset=False, test=False,
                               root="../data/EuroSAT_RGB", **kw):
    ds = EuroSATDataset(root)
    train_ds, test_ds = train_val_split(ds, val_split, SEED)
    if return_dataset:
        return train_ds, test_ds
    return _loaders(train_ds, test_ds, batch_size, num_workers=num_workers,
                    transforms=None if test else _FLIPS)


def create_sen12mscr_dataloaders(batch_size, num_workers=0, val_split=0.15, SEED=4097,
                                 return_dataset=False, test=False,
                                 root="../data/SEN12MS_CR", season="ROIs1868_summer", **kw):
    """SEN12MS-CR cloud-removal pairs: clear S2 RGB as target, cloudy S2 RGB
    as "cond_image" for concat-conditional training (README.md:13-20)."""
    from eo_diffusion_torch.data.sen12ms_cr import SEN12MSCRCloudRemoval

    ds = SEN12MSCRCloudRemoval(root, season=season,
                               **{k: v for k, v in kw.items() if k in ("reader", "scale")})
    train_ds, test_ds = train_val_split(ds, val_split, SEED)
    if return_dataset:
        return train_ds, test_ds
    return _loaders(train_ds, test_ds, batch_size, num_workers=num_workers,
                    transforms=None if test else _FLIPS)


def create_synthetic_dataloaders(batch_size, image_size=64, length=1024, channels=3,
                                 val_split=0.15, SEED=4097, num_classes=5,
                                 data_range=(0.0, 1.0), shard=(0, 1),
                                 with_cond_image=False, hard=False, **kw):
    cls = SyntheticEOHard if hard else SyntheticEO
    ds = cls(size=image_size, length=length, channels=channels,
             num_classes=num_classes, data_range=data_range,
             with_cond_image=with_cond_image)
    train_ds, test_ds = train_val_split(ds, val_split, SEED)
    # no prefetch thread: the synthetic items are numpy that holds the GIL,
    # so a thread building them only takes host time from the step's
    # launches (the batches are the same either way)
    return _loaders(train_ds, test_ds, batch_size, transforms=_FLIPS, shard=shard,
                    prefetch=0)


def create_synthetic_hard_dataloaders(batch_size, **kw):
    """The discriminative-evaluation fixture (``--dataset synthetic_hard``):
    multi-modal class-diverse SyntheticEOHard, same loader surface."""
    kw.pop("hard", None)
    return create_synthetic_dataloaders(batch_size, hard=True, **kw)


DATASET_FACTORIES = {
    "mnist": create_mnist_dataloaders,
    "cifar10": create_cifar10_dataloaders,
    "inria": create_inria_dataloaders,
    "clouds": create_cloud_dataloaders,
    "oscd": create_oscd_dataloaders,
    "sarwake": create_SARWake_dataloaders,
    "eurosat": create_Eurosat_dataloaders,
    "sen12mscr": create_sen12mscr_dataloaders,
    "synthetic": create_synthetic_dataloaders,
    "synthetic_hard": create_synthetic_hard_dataloaders,
}
