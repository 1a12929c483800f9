"""FID / KID / PRDC / Inception-Score evaluation CLI of the port.

The port's copy of ``eo_diffusion_tpu/cli/evaluate.py`` (the re-design of
the reference's torch-fidelity harness, ``script_utils/evaluate_metrics.py:
3-17``): the Frechet distance, KID, precision/recall/density/coverage and
the pixel-space guards between a directory of real images and one of
generated samples, plus the inception score when the extractor gives class
probabilities.

The default extractor is the deterministic random-projection fallback
(``utils.metrics.tiny_feature_extractor``), self-consistent for tracking
relative progress; ``--extractor inception`` takes a torchvision
``inception_v3_google`` state dict (``--inception_weights`` or
``EO_INCEPTION_WEIGHTS``; none is bundled) for published-comparable numbers.
The extractor runs on the GPU (``--device cuda``, the default) and the CLI
exits when there is none; the CPU is used only with ``--device cpu``. The
feature statistics are numpy/scipy on the host.

``python -m eo_diffusion_torch.cli.evaluate --real results/eval/samples
--fake results/eval/samples_fid``
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch


def load_image_dir(path: str, limit: int = 0) -> np.ndarray:
    """The ``*.png`` and ``*.jpg`` files of ``path`` (sorted, the first
    ``limit``) as RGB float32 [0, 1], cropped to their smallest common size."""
    from PIL import Image

    files = sorted(glob.glob(os.path.join(path, "*.png")) + glob.glob(os.path.join(path, "*.jpg")))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    imgs = []
    for f in files:
        with Image.open(f) as im:
            imgs.append(np.asarray(im.convert("RGB"), np.float32) / 255.0)
    shapes = {im.shape for im in imgs}
    if len(shapes) > 1:  # crop everything to the smallest common size
        h = min(s[0] for s in shapes)
        w = min(s[1] for s in shapes)
        imgs = [im[:h, :w] for im in imgs]
    return np.stack(imgs)


def compute_metrics(real: np.ndarray, fake: np.ndarray, extractor=None, batch: int = 64,
                    with_logits: bool = False, device=None) -> dict:
    """FID/KID/PRDC between two image stacks, plus IS of the fake stack when
    the extractor also yields class probabilities (``with_logits=True``: it
    returns ``(feats, probs)`` a batch). Without an extractor the offline
    random projection runs on ``device``."""
    from eo_diffusion_torch.utils.metrics import (FrechetDistance, density_coverage,
                                                  gradient_energy, inception_score, kid,
                                                  pairwise_l2, precision_recall,
                                                  spectral_distance, tiny_feature_extractor)

    fd = FrechetDistance(None if with_logits
                         else extractor or tiny_feature_extractor(device=device))
    probs = []
    if with_logits:
        for i in range(0, len(real), batch):
            fd.add_real_feats(extractor(real[i:i + batch])[0])
        for i in range(0, len(fake), batch):
            f, p = extractor(fake[i:i + batch])
            fd.add_fake_feats(f)
            probs.append(p)
    else:
        for i in range(0, len(real), batch):
            fd.update_real(real[i:i + batch])
        for i in range(0, len(fake), batch):
            fd.update_fake(fake[i:i + batch])
    rf, ff = np.concatenate(fd._real), np.concatenate(fd._fake)
    kid_mean, kid_std = kid(rf, ff)
    # d_rr/d_fr are the dominant PRDC cost: computed once for the quartet
    d_rr, d_fr = pairwise_l2(rf, rf), pairwise_l2(ff, rf)
    density, coverage = density_coverage(rf, ff, k=min(5, len(rf) - 1), d_rr=d_rr, d_fr=d_fr)
    precision, recall = precision_recall(rf, ff, k=min(3, len(rf) - 1, len(ff) - 1),
                                         d_rr=d_rr, d_fr=d_fr)
    out = {
        "frechet_distance": fd.compute(),
        "kid_mean": kid_mean,
        "kid_std": kid_std,
        "precision": precision,
        "recall": recall,
        "density": density,
        "coverage": coverage,
        # pixel-space guards for what feature metrics miss (the offline
        # extractor's KID is blind to iid noise)
        "grad_energy_real": gradient_energy(real),
        "grad_energy_fake": gradient_energy(fake),
        "spectral_distance": spectral_distance(real, fake),
        "n_real": len(real),
        "n_fake": len(fake),
    }
    if probs:
        is_mean, is_std = inception_score(np.concatenate(probs))
        out["inception_score"] = is_mean
        out["inception_score_std"] = is_std
    return out


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("eo_diffusion_torch.cli.evaluate: no CUDA device is "
                         "available; pass --device cpu to evaluate on the CPU")
    return device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="FID/KID/IS evaluation (PyTorch/CUDA)")
    ap.add_argument("--real", required=True, help="dir of real images (or dataset name)")
    ap.add_argument("--fake", required=True, help="dir of generated samples")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--out", type=str, default=None, help="write metrics JSON here")
    ap.add_argument("--extractor", choices=["offline", "inception"], default="offline",
                    help="offline = deterministic random-projection features "
                         "(KID recommended); inception = InceptionV3 pool3 "
                         "features for published-comparable FID + IS")
    ap.add_argument("--inception_weights", type=str,
                    default=os.environ.get("EO_INCEPTION_WEIGHTS", ""),
                    help="torchvision inception_v3_google .pth")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; never falls back silently")
    return ap.parse_args(argv)


def main(args) -> dict:
    device = resolve_device(args.device)
    extractor, with_logits = None, False
    if args.extractor == "inception":
        from eo_diffusion_torch.models.inception import (inception_feature_extractor,
                                                         load_torch_inception)

        if not args.inception_weights or not os.path.exists(args.inception_weights):
            raise SystemExit(
                "--extractor inception needs --inception_weights (or "
                "EO_INCEPTION_WEIGHTS) pointing at a torchvision "
                "inception_v3_google state dict; no weights are bundled."
            )
        model = load_torch_inception(args.inception_weights, device)
        extractor = inception_feature_extractor(model, args.batch, with_logits=True)
        with_logits = True

    real = load_image_dir(args.real, args.limit)
    fake = load_image_dir(args.fake, args.limit)
    metrics = compute_metrics(real, fake, extractor=extractor, batch=args.batch,
                              with_logits=with_logits, device=device)
    print(metrics)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main(parse_args())
