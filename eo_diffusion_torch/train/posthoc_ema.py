"""Post-hoc EMA: power-function EMA tracks, and any EMA length synthesized
after training (Karras et al., arXiv:2312.02696 §3.3 and App. C), in PyTorch.

Counterpart of ``eo_diffusion_tpu/train/posthoc_ema.py``. The trainer keeps
K power-function EMA tracks, ``beta(t) = (1 - 1/t) ** (gamma + 1)``, whose
averaging profile over history is ``p(tau) ∝ tau^gamma``; snapshots of them
at every checkpoint span, to high accuracy, every power-EMA profile, so the
parameters of any EMA length (``sigma_rel``) are a least-squares weighted
sum of the snapshots (:func:`solve_weights`, :func:`synthesize`). The
closed forms are the numpy ones of the JAX package, copied.

A track is a state dict (parameter name -> float32 tensor, on the
parameters' device). A snapshot is ``phema_<step:08d>_g<gamma:.6f>.npz``:
the port writes the state-dict names as keys; the JAX package's snapshots
have flax ``keystr`` keys (``['params']['input_0_0']['kernel']``), which
:func:`load_tree` turns into the port's state dict through
``eo_diffusion_torch.weights``' converters, given the backbone's config.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from eo_diffusion_torch.train.ema import ema_update

__all__ = ["PowerEMA", "sigma_rel_to_gamma", "gamma_to_sigma_rel", "solve_weights",
           "synthesize", "load_tree", "load_snapshots", "synthesize_from_dir",
           "DEFAULT_GAMMAS"]

# the paper's std pair: sigma_rel 0.05 and 0.10 (arXiv:2312.02696 App. C)
DEFAULT_GAMMAS = (16.970562, 6.944101)

_SNAP_RE = re.compile(r"phema_(\d{8})_g([0-9.]+)\.npz$")
_KEYSTR = re.compile(r"\['([^']*)'\]")

Tree = Dict[str, torch.Tensor]


def gamma_to_sigma_rel(gamma: float) -> float:
    g = float(gamma)
    return float(np.sqrt((g + 1.0) / ((g + 2.0) ** 2 * (g + 3.0))))


def sigma_rel_to_gamma(sigma_rel: float) -> float:
    """Invert sigma_rel(gamma): the real root > -1 of ``g^3 + 7g^2 + (16 -
    1/sr^2) g + (12 - 1/sr^2) = 0``."""
    sr = float(sigma_rel)
    assert 0.0 < sr <= 0.28, f"sigma_rel {sr} outside the valid profile range (max ~0.2886)"
    c = sr ** -2
    roots = np.roots([1.0, 7.0, 16.0 - c, 12.0 - c])
    real = roots[np.abs(roots.imag) < 1e-8].real
    real = real[real > -1.0]
    assert len(real), (sigma_rel, roots)
    return float(real.max())


def _profile_dot(g_a: float, t_a: float, g_b: float, t_b: float) -> float:
    t_min = min(t_a, t_b)
    if t_min <= 0:
        return 0.0
    log = ((g_a + g_b + 1.0) * np.log(t_min)
           - (g_a + 1.0) * np.log(t_a) - (g_b + 1.0) * np.log(t_b))
    return float((g_a + 1.0) * (g_b + 1.0) / (g_a + g_b + 1.0) * np.exp(log))


def solve_weights(snaps: Sequence[Tuple[float, float]], gamma_target: float,
                  t_target: float) -> np.ndarray:
    """Least-squares weights reconstructing the profile ``(gamma_target,
    t_target)`` from the snapshot profiles ``snaps = [(t_i, gamma_i), ...]``
    (paper App. C: A w = b with the closed-form profile inner products, a
    1e-10 ridge for near-collinear snapshots)."""
    n = len(snaps)
    assert n, "no snapshots"
    a = np.empty((n, n))
    b = np.empty((n,))
    for i, (t_i, g_i) in enumerate(snaps):
        b[i] = _profile_dot(g_i, t_i, gamma_target, t_target)
        for j, (t_j, g_j) in enumerate(snaps):
            a[i, j] = _profile_dot(g_i, t_i, g_j, t_j)
    return np.linalg.solve(a + 1e-10 * np.eye(n), b)


@torch.no_grad()
def synthesize(trees: Sequence[Mapping[str, torch.Tensor]], weights: np.ndarray) -> Tree:
    """The weighted sum of state dicts, accumulated in float32 and returned
    in the first tree's dtypes."""
    assert len(trees) == len(weights) and len(trees)
    out = {}
    for name, first in trees[0].items():
        acc = sum(float(w) * tr[name].float() for w, tr in zip(weights, trees))
        out[name] = acc.to(first.dtype)
    return out


@dataclasses.dataclass(frozen=True)
class PowerEMA:
    """K power-function EMA tracks over a model's parameters."""

    gammas: Tuple[float, ...] = DEFAULT_GAMMAS

    @torch.no_grad()
    def init(self, params: Mapping[str, torch.Tensor]) -> List[Tree]:
        """One float32 copy of ``params`` (name -> tensor) a gamma."""
        return [{k: v.detach().float().clone() for k, v in params.items()}
                for _ in self.gammas]

    @torch.no_grad()
    def update(self, tracks: List[Tree], params: Mapping[str, torch.Tensor], step: int
               ) -> List[Tree]:
        """One power-EMA step in place (``train.ema.ema_update``'s
        ``_foreach`` update, a track at a time); ``step`` is 0-based (t =
        step + 1). ``beta`` is computed in float32 as the JAX package's jitted
        update does."""
        t = max(np.float32(step) + np.float32(1.0), np.float32(1.0))
        for g, tr in zip(self.gammas, tracks):
            beta = float((np.float32(1.0) - np.float32(1.0) / t) ** np.float32(g + 1.0))
            ema_update(list(tr.values()), [params[k] for k in tr], beta)
        return tracks

    def save_snapshots(self, dirpath: str, tracks: List[Tree], step: int) -> List[str]:
        """Write each track as ``phema_<step:08d>_g<gamma:.6f>.npz`` under
        ``dirpath`` (state-dict names as keys)."""
        os.makedirs(dirpath, exist_ok=True)
        paths = []
        for g, tr in zip(self.gammas, tracks):
            p = os.path.join(dirpath, f"phema_{step:08d}_g{g:.6f}.npz")
            np.savez(p, **{k: v.detach().cpu().numpy() for k, v in tr.items()})
            paths.append(p)
        return paths

    def restore_latest(self, dirpath: str, template: Mapping[str, torch.Tensor], cfg=None
                       ) -> Tuple[List[Tree], int]:
        """Resume: the tracks from the newest snapshot of each gamma, on
        ``template``'s devices (``init(template)`` when a gamma has none).
        Returns ``(tracks, latest_step)``, -1 for a fresh start."""
        found = {}
        for p, step, g in _list_snaps(dirpath):
            if g in [round(x, 6) for x in self.gammas]:
                if g not in found or step > found[g][1]:
                    found[g] = (p, step)
        if len(found) < len(self.gammas):
            return self.init(template), -1
        tracks = [{k: v.float() for k, v in load_tree(found[round(g, 6)][0], template,
                                                       cfg).items()}
                  for g in self.gammas]
        return tracks, min(s for _, s in found.values())


def _list_snaps(dirpath: str):
    if not os.path.isdir(dirpath):
        return
    for f in sorted(os.listdir(dirpath)):
        m = _SNAP_RE.match(f)
        if m:
            yield os.path.join(dirpath, f), int(m.group(1)), round(float(m.group(2)), 6)


def _convert_flax(arrays: Mapping[str, np.ndarray], cfg) -> Dict[str, torch.Tensor]:
    """A flat ``{keystr: array}`` of a flax param tree -> the port's state
    dict, through the converter of ``cfg``'s backbone."""
    from eo_diffusion_torch.weights import backbone_state_dict_from_jax_params

    if cfg is None:
        raise ValueError("a snapshot with flax keys needs the backbone's config (cfg=)")
    tree: Dict = {}
    for key, arr in arrays.items():
        parts = _KEYSTR.findall(key)
        if "".join(f"['{p}']" for p in parts) != key:
            raise KeyError(f"not a flax keystr: {key!r}")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr
    return backbone_state_dict_from_jax_params(tree, cfg)


def load_tree(path: str, template: Mapping[str, torch.Tensor], cfg=None) -> Tree:
    """One snapshot as a state dict matching ``template`` (names, shapes,
    dtypes and devices). Keys that are flax ``keystr`` paths (a snapshot of
    the JAX package) are converted with ``cfg``, the backbone's config."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    if arrays and all(k.startswith("[") for k in arrays):
        sd = _convert_flax(arrays, cfg)
    else:
        sd = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    out = {}
    for k, v in template.items():
        assert k in sd, f"snapshot {path} missing leaf {k}"
        assert tuple(sd[k].shape) == tuple(v.shape), (k, tuple(sd[k].shape), tuple(v.shape))
        out[k] = sd[k].to(device=v.device, dtype=v.dtype)
    return out


def load_snapshots(dirpath: str, template: Mapping[str, torch.Tensor], cfg=None
                   ) -> Tuple[List[Tree], List[Tuple[float, float]]]:
    """Every snapshot under ``dirpath``: ``(trees, [(t, gamma)])`` with t =
    step + 1, the profile end-time of the stored track."""
    trees, meta = [], []
    for p, step, g in _list_snaps(dirpath):
        trees.append(load_tree(p, template, cfg))
        meta.append((float(step + 1), g))
    assert trees, f"no phema_*.npz snapshots under {dirpath}"
    return trees, meta


def synthesize_from_dir(dirpath: str, template: Mapping[str, torch.Tensor], sigma_rel: float,
                        t_target: Optional[float] = None, cfg=None) -> Tree:
    """Load every snapshot under ``dirpath`` and synthesize the EMA profile
    of ``sigma_rel`` at ``t_target`` (default: the newest snapshot's)."""
    trees, meta = load_snapshots(dirpath, template, cfg)
    tt = max(t for t, _ in meta) if t_target is None else float(t_target)
    return synthesize(trees, solve_weights(meta, sigma_rel_to_gamma(sigma_rel), tt))
