"""Export dataset patches to disk (offline patch materialization).

The port's copy of the JAX package's ``tools/export_patches.py``, a
re-design of the reference's data tooling (``data_utils/create_data.py``
patch-export scripts and ``make_patches``' outpath mode,
``data_load.py:191-206``): stream any registered dataset and write its
patches as PNGs (plus an ``images.txt`` index of patch -> source metadata),
so training can run from a flat patch directory.

``python -m eo_diffusion_torch.tools.export_patches --dataset synthetic
--out /data/patches --limit 512``
"""

from __future__ import annotations

import argparse
import os


def export(dataset, out_dir: str, limit: int = 0, prefix: str = "patch") -> int:
    from eo_diffusion_torch.utils.images import save_image_grid

    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset) if not limit else min(limit, len(dataset))
    index_path = os.path.join(out_dir, "images.txt")
    with open(index_path, "w") as idx:
        for i in range(n):
            item = dataset[i]
            name = f"{prefix}_{i:06d}.png"
            save_image_grid(item["image"], os.path.join(out_dir, name),
                            nrow=1, data_range=dataset.data_range)
            cls = int(item["class"]) if "class" in item else -1
            idx.write(f"{name} {cls}\n")
            if "segmentation" in item:
                mask_name = f"{prefix}_{i:06d}_mask.png"
                save_image_grid(item["segmentation"], os.path.join(out_dir, mask_name), nrow=1)
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export dataset patches to PNGs")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--root", default=None, help="dataset root directory")
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args(argv)

    from eo_diffusion_torch.data.factories import DATASET_FACTORIES

    fkw = dict(batch_size=1, return_dataset=True)
    if args.root:
        fkw["root"] = args.root
    if args.dataset == "synthetic":
        fkw["image_size"] = args.image_size
        fkw.pop("return_dataset")
        train_loader, _ = DATASET_FACTORIES[args.dataset](**fkw)
        ds = train_loader.dataset
    else:
        ds, _ = DATASET_FACTORIES[args.dataset](**fkw)
    n = export(ds, args.out, args.limit)
    print(f"exported {n} patches to {args.out}")
    return n


if __name__ == "__main__":
    main()
