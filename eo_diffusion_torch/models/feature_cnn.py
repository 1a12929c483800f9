"""Discriminative feature extractor for offline KID/FID, in PyTorch.

The port's copy of ``eo_diffusion_tpu/models/feature_cnn.py``: a small
convnet trained to predict the synthetic fixture's classes at full
resolution, whose penultimate global-average-pool features (unit RMS per
sample) feed KID/FID where no InceptionV3 weights are mounted. Unlike the
random projection of ``utils.metrics.tiny_feature_extractor`` its first conv
runs at native resolution, so noise, blur and checkerboard artifacts move
the features.

Weights live in the JAX package's flat ``.npz`` layout (``params/conv0a/
kernel`` HWIO, ``params/gn0/scale``, ``params/head/kernel`` [in, out],
``__meta__/...``), read and written by :func:`load_params` /
:func:`save_params` as a nested dict of numpy arrays (the flax tree), so
``gallery/eval_extractor*.npz`` load unchanged and a file saved by either
package loads in the other. :func:`state_dict_from_params` and
:func:`params_from_state_dict` convert between that tree and the module.

Flax details kept: ``padding="SAME"`` pads a stride-2 3x3 conv (0, 1) on an
even input (not (1, 1)), GroupNorm has eps 1e-6. Activations are NHWC at the
boundary, NCHW inside.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FeatureCNN", "FeatureCNNConfig", "train_feature_extractor", "save_params",
           "load_params", "make_extractor", "make_two_stream_extractor",
           "state_dict_from_params", "params_from_state_dict"]

_GN_EPS = 1e-6  # flax nn.GroupNorm's default


@dataclasses.dataclass(frozen=True)
class FeatureCNNConfig:
    in_channels: int = 3
    widths: Tuple[int, ...] = (32, 64, 128, 192)
    num_classes: int = 5
    feature_dim: int = 192  # penultimate width == widths[-1] after pool
    norm_groups: int = 8


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad NCHW ``x`` as flax/XLA ``padding="SAME"`` does for a ``k`` x ``k``
    conv of stride ``s``: the total ``max((ceil(n / s) - 1) * s + k - n, 0)``,
    the smaller half before."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dimension first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class FeatureCNN(nn.Module):
    """4-stage convnet: [conv3x3, GN, SiLU, stride-2 conv, SiLU] per stage,
    global-average-pool penultimate features, linear class head. Module
    names are the flax ones (``conv{i}a``, ``gn{i}``, ``conv{i}b``,
    ``head``)."""

    def __init__(self, cfg: FeatureCNNConfig):
        super().__init__()
        self.cfg = cfg
        c_in = cfg.in_channels
        for i, w in enumerate(cfg.widths):
            self.add_module(f"conv{i}a", nn.Conv2d(c_in, w, 3))
            self.add_module(f"gn{i}", nn.GroupNorm(min(cfg.norm_groups, w), w, eps=_GN_EPS))
            self.add_module(f"conv{i}b", nn.Conv2d(w, w, 3, stride=2))
            c_in = w
        self.head = nn.Linear(cfg.widths[-1], cfg.num_classes)

    def forward(self, x: torch.Tensor, features_only: bool = False):
        """x ``[N, H, W, C]`` float32. Returns the unit-RMS features ``[N,
        widths[-1]]`` with ``features_only``, else ``(logits, feats)`` with
        the raw pooled features."""
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.cfg.widths)):
            h = getattr(self, f"conv{i}a")(_same_pad(h, 3, 1))
            h = F.silu(getattr(self, f"gn{i}")(h))
            h = F.silu(getattr(self, f"conv{i}b")(_same_pad(h, 3, 2)))
        feats = h.mean(dim=(2, 3))
        if features_only:
            # unit RMS per sample: KID's cubic kernel (x.y/d + 1)^3 needs dot
            # products O(d); direction carries the discriminative signal
            rms = torch.sqrt(torch.mean(feats ** 2, dim=-1, keepdim=True))
            return feats / torch.clamp(rms, min=1e-8)
        return self.head(feats), feats


def config_from_params(params) -> FeatureCNNConfig:
    """The config of a saved tree: widths read from the conv stack present."""
    p = params["params"]
    widths, i = [], 0
    while f"conv{i}a" in p:
        widths.append(int(np.shape(p[f"conv{i}a"]["kernel"])[-1]))
        i += 1
    return FeatureCNNConfig(in_channels=int(np.shape(p["conv0a"]["kernel"])[-2]),
                            widths=tuple(widths),
                            num_classes=int(np.shape(p["head"]["kernel"])[-1]),
                            feature_dim=widths[-1])


def state_dict_from_params(params) -> Dict[str, torch.Tensor]:
    """Flax tree (``{"params": {...}}``, numpy leaves) -> the module's state
    dict: kernels HWIO -> OIHW, the head's [in, out] -> [out, in]."""
    sd = {}
    for name, leaves in params["params"].items():
        for leaf, v in leaves.items():
            v = np.asarray(v, np.float32)
            if leaf == "kernel":
                sd[f"{name}.weight"] = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            else:  # conv/dense bias, GroupNorm scale and bias
                sd[f"{name}.{'weight' if leaf == 'scale' else 'bias'}"] = v
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def params_from_state_dict(model: FeatureCNN) -> dict:
    """The module's weights as the flax tree (numpy leaves)."""
    tree: dict = {}
    for key, v in model.state_dict().items():
        name, leaf = key.split(".")
        v = v.detach().cpu().numpy()
        if leaf == "weight" and v.ndim > 1:
            tree.setdefault(name, {})["kernel"] = (v.transpose(2, 3, 1, 0) if v.ndim == 4
                                                   else v.T).copy()
        else:
            flax_leaf = "scale" if name.startswith("gn") and leaf == "weight" else "bias"
            tree.setdefault(name, {})[flax_leaf] = v.copy()
    return {"params": tree}


def build_model(params, cfg: Optional[FeatureCNNConfig] = None, device=None) -> FeatureCNN:
    """A :class:`FeatureCNN` holding the flax tree ``params``, in eval mode."""
    model = FeatureCNN(cfg or config_from_params(params))
    model.load_state_dict(state_dict_from_params(params), strict=True)
    return model.to(device).eval()


def train_feature_extractor(images: np.ndarray, labels: np.ndarray,
                            cfg: Optional[FeatureCNNConfig] = None, steps: int = 2000,
                            batch_size: int = 64, lr: float = 2e-3, seed: int = 0,
                            log_every: int = 0, device=None):
    """Train the extractor with cross-entropy and flip augmentation, as the
    JAX function does: AdamW (optax's defaults, weight decay 1e-4) on a
    cosine decay from ``lr`` to 0 over ``steps``, batches of ``batch_size``
    drawn with replacement, a horizontal and a vertical flip of the whole
    batch each with probability 1/2. The fixture lives on ``device``.

    ``images``: [N, H, W, C] float32 in any fixed range; ``labels``: [N]
    int. Returns ``(params, val_accuracy)``, the params as the flax tree and
    the accuracy on a held-out 10 % split.
    """
    cfg = cfg or FeatureCNNConfig(in_channels=images.shape[-1],
                                  num_classes=int(labels.max()) + 1)
    n = len(images)
    n_val = max(n // 10, 1)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    val_idx, train_idx = perm[:n_val], perm[n_val:]

    torch.manual_seed(seed)
    model = FeatureCNN(cfg).to(device)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    data = torch.as_tensor(np.asarray(images, np.float32), device=device)
    targets = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=device)
    gen = torch.Generator(device=data.device).manual_seed(seed + 1)
    for i in range(steps):
        for g in opt.param_groups:  # optax.cosine_decay_schedule(lr, steps)
            g["lr"] = lr * 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / max(steps, 1)))
        idx = torch.as_tensor(rng.choice(train_idx, batch_size), device=data.device)
        x, y = data[idx], targets[idx]
        flip_h, flip_v = torch.rand(2, generator=gen, device=data.device) < 0.5
        x = torch.where(flip_h, x.flip(2), x)
        x = torch.where(flip_v, x.flip(1), x)
        logits, _ = model(x)
        loss = F.cross_entropy(logits, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and i % log_every == 0:
            acc = (logits.argmax(-1) == y).float().mean()
            print(f"extractor step {i}/{steps} loss={float(loss):.4f} "
                  f"acc={float(acc):.3f}", flush=True)
    model.eval()
    with torch.no_grad():
        vi = torch.as_tensor(val_idx, device=data.device)
        val_acc = float((model(data[vi])[0].argmax(-1) == targets[vi]).float().mean())
    return params_from_state_dict(model), val_acc


def _flatten(params, prefix=""):
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_params(params, path: str, meta: Optional[dict] = None) -> str:
    """Persist extractor params (the flax tree) as a flat .npz."""
    flat = _flatten(params)
    if meta:
        for k, v in meta.items():
            flat[f"__meta__/{k}"] = np.asarray(v)
    np.savez(path, **flat)
    return path


def load_params(path: str):
    """Inverse of save_params. Returns (params, meta), numpy leaves."""
    flat = np.load(path)
    params, meta = {}, {}
    for key in flat.files:
        if key.startswith("__meta__/"):
            meta[key.split("/", 1)[1]] = flat[key]
            continue
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return params, meta


def make_extractor(params, cfg: Optional[FeatureCNNConfig] = None, batch: int = 256,
                   device=None) -> Callable:
    """Wrap trained params (the flax tree; the config is read from it when
    not given) as a feature callable for FrechetDistance/kid: ``[N, H, W, C]``
    (numpy or tensor, any N) -> ``[N, feature_dim]`` float32 numpy unit-RMS
    features, computed on ``device`` in ``batch``-sized chunks."""
    model = build_model(params, cfg, device)

    @torch.no_grad()
    def extract(x) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                            dtype=torch.float32)
        dev = next(model.parameters()).device
        outs = [model(x[s:s + batch].to(dev), features_only=True).cpu().numpy()
                for s in range(0, x.shape[0], batch)]
        return np.concatenate(outs, 0)

    return extract


def make_two_stream_extractor(tile_params, tile_cfg: FeatureCNNConfig, tile: int,
                              global_params, global_cfg: FeatureCNNConfig, down: int,
                              batch: int = 256, device=None) -> Callable:
    """Texture + composition features for high-resolution KID.

    Stream A (texture): the tile extractor on the non-overlapping
    ``tile``-sized grid, mean-pooled over tiles. Stream B (composition): a
    second FeatureCNN on ``down``x average-pool-downsampled full images, so
    scrambling tiles moves it. Each stream is L2-normalized per sample
    before concatenation so neither scale dominates the KID kernel.
    """
    tile_extract = make_extractor(tile_params, tile_cfg, batch=batch, device=device)
    global_extract = make_extractor(global_params, global_cfg, batch=batch, device=device)

    def _l2(f):
        return f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-8)

    def extract(x):
        x = np.asarray(x, np.float32)
        n, h, w, c = x.shape
        gh, gw = h // tile, w // tile
        tiles = (x.reshape(n, gh, tile, gw, tile, c)
                 .transpose(0, 1, 3, 2, 4, 5)
                 .reshape(n * gh * gw, tile, tile, c))
        tex = tile_extract(tiles).reshape(n, gh * gw, -1).mean(axis=1)
        xd = x.reshape(n, h // down, down, w // down, down, c).mean((2, 4))
        comp = global_extract(xd)
        return np.concatenate([_l2(tex), _l2(comp)], axis=-1)

    return extract
