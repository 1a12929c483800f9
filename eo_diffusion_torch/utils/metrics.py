"""Evaluation metrics: SSIM, PSNR, the FID/KID/PRDC machinery, in PyTorch.

The port's copy of ``eo_diffusion_tpu/utils/metrics.py`` (itself the
replacement of the reference's torchmetrics SSIM/PSNR calls, inference.py:7-8,
136-138, and the torch-fidelity FID/IS harness,
``script_utils/evaluate_metrics.py:3-17``):

* :func:`ssim` -- Wang et al. SSIM with an 11x11 Gaussian window (sigma
  1.5), torchmetrics' defaults, NHWC, batched, on the tensors' own device;
* :func:`psnr` -- peak signal-to-noise ratio over the whole batch;
* :class:`FrechetDistance` -- feature statistics and the exact Frechet
  distance between Gaussians (``scipy.linalg.sqrtm`` on the host). The
  feature extractor is pluggable: any callable ``[N, H, W, C] -> [N, D]``;
  :func:`tiny_feature_extractor` is the deterministic offline fallback;
* :func:`kid`, :func:`inception_score`, :func:`density_coverage`,
  :func:`precision_recall`, :func:`gradient_energy`,
  :func:`spectral_distance`: numpy on the host, as in JAX.

:func:`resize_bilinear` is ``jax.image.resize(..., "bilinear")``: the
separable triangle kernel of JAX's scale-and-translate, widened by the
scale when it downsamples (anti-aliasing), as two matmuls.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ssim", "psnr", "FrechetDistance", "tiny_feature_extractor", "resize_bilinear",
           "inception_score", "kid", "pairwise_l2", "density_coverage", "precision_recall",
           "gradient_energy", "radial_power_profile", "spectral_distance"]


def _tensor(x, device=None) -> torch.Tensor:
    """``x`` (numpy or tensor) as a float32 tensor on ``device`` (default:
    where it is, the CPU for numpy)."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of JAX's linear ``compute_weight_mat``
    (``jax/_src/image/scale.py``) at scale n_out / n_in, no translation,
    antialias on: triangle taps over the input pixels, normalised per output
    pixel, zero where the sample lies outside the input."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NHWC float32 ``x`` resized to ``height`` x ``width`` as
    ``jax.image.resize(x, (n, height, width, c), "bilinear")`` does: a
    dimension whose size does not change is left alone."""
    _, h, w, _ = x.shape
    if h != height:
        wh = torch.from_numpy(_resize_weights(h, height)).to(x.device)
        x = torch.einsum("nhwc,hk->nkwc", x, wh)
    if w != width:
        ww = torch.from_numpy(_resize_weights(w, width)).to(x.device)
        x = torch.einsum("nhwc,wk->nhkc", x, ww)
    return x


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 'valid' convolution of NCHW with a 2-D kernel."""
    c = img.shape[1]
    k = kernel[None, None].expand(c, 1, *kernel.shape)
    return F.conv2d(img, k, groups=c)


def ssim(pred, target, data_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a batch (NHWC), torchmetrics-compatible defaults; a
    0-dim float32 tensor on the inputs' device."""
    pred, target = _tensor(pred), _tensor(target)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    # clamp the window to the image (keeps tiny smoke-test images finite)
    kernel_size = min(kernel_size, pred.shape[1], pred.shape[2])
    if kernel_size % 2 == 0:
        kernel_size -= 1
    kern = _gaussian_kernel(kernel_size, sigma, pred.device)
    x, y = pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)

    mu_x, mu_y = _filter2d(x, kern), _filter2d(y, kern)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = _filter2d(x * x, kern) - mu_xx
    sigma_y = _filter2d(y * y, kern) - mu_yy
    sigma_xy = _filter2d(x * y, kern) - mu_xy

    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)


def psnr(pred, target, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the whole batch (torchmetrics' default
    reduction: one MSE over all elements); a 0-dim float32 tensor."""
    mse = torch.mean((_tensor(pred) - _tensor(target)) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def tiny_feature_extractor(dim: int = 192, seed: int = 0, device=None) -> Callable:
    """Deterministic random-projection features (the offline FID fallback).

    Projects 16x16-downsampled images through a fixed random matrix + ReLU,
    on ``device`` (default: the CPU), and returns float32 numpy features.
    The matrix is drawn from ``np.random.default_rng(seed)`` at the first
    call (again when the input width changes), as JAX draws it. NOT
    comparable to Inception-FID numbers, but monotone in distribution
    mismatch and fully offline.
    """
    rng = np.random.default_rng(seed)
    w = None

    def extract(batch) -> np.ndarray:
        nonlocal w
        x = resize_bilinear(_tensor(batch, device), 16, 16)
        flat = x.reshape(x.shape[0], -1)
        if w is None or w.shape[0] != flat.shape[1]:
            w = torch.from_numpy(rng.normal(0, 1 / np.sqrt(flat.shape[1]),
                                            (flat.shape[1], dim)).astype(np.float32))
        return _numpy(torch.relu(flat @ w.to(flat.device)))

    return extract


def _sqrtm(m: np.ndarray) -> np.ndarray:
    """``scipy.linalg.sqrtm(m)``: SciPy < 1.18 returns (root, error estimate)
    with ``disp=False``, as the JAX package calls it; later versions dropped
    ``disp`` and return the root."""
    import inspect

    import scipy.linalg

    kw = {"disp": False} if "disp" in inspect.signature(scipy.linalg.sqrtm).parameters else {}
    out = scipy.linalg.sqrtm(m, **kw)
    return out[0] if isinstance(out, tuple) else out


class FrechetDistance:
    """Streaming Frechet distance between two feature distributions.

    Usage::

        fd = FrechetDistance(extractor)
        for batch in real_loader:   fd.update_real(batch["image"])
        for batch in samples:       fd.update_fake(batch)
        score = fd.compute()
    """

    def __init__(self, extractor: Optional[Callable] = None):
        self.extractor = extractor or tiny_feature_extractor()
        self._real: list = []
        self._fake: list = []

    def update_real(self, images):
        self._real.append(_numpy(self.extractor(images)))

    def update_fake(self, images):
        self._fake.append(_numpy(self.extractor(images)))

    # pre-extracted features (e.g. when one Inception pass yields both
    # pool3 feats for FID and logits for IS)
    def add_real_feats(self, feats):
        self._real.append(_numpy(feats))

    def add_fake_feats(self, feats):
        self._fake.append(_numpy(feats))

    @staticmethod
    def _stats(feats: np.ndarray):
        mu = feats.mean(0)
        cov = np.cov(feats, rowvar=False)
        return mu, np.atleast_2d(cov)

    @staticmethod
    def frechet(mu1, cov1, mu2, cov2) -> float:
        """d^2 = |mu1-mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)).

        Where the square root of the product is not finite (a singular
        product, fewer samples than feature dimensions, on a SciPy whose
        ``sqrtm`` returns NaN there), both covariances get 1e-6 on their
        diagonal first, as torch-fidelity and pytorch-fid do."""
        diff = mu1 - mu2
        covmean = _sqrtm(cov1 @ cov2)
        if not np.isfinite(covmean).all():
            offset = np.eye(cov1.shape[0]) * 1e-6
            covmean = _sqrtm((cov1 + offset) @ (cov2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(covmean))

    def compute(self) -> float:
        real = np.concatenate(self._real)
        fake = np.concatenate(self._fake)
        return self.frechet(*self._stats(real), *self._stats(fake))


def kid(real_feats: np.ndarray, fake_feats: np.ndarray, subset_size: int = 100,
        num_subsets: int = 20, seed: int = 0) -> tuple:
    """Kernel Inception Distance (Binkowski et al. 2018): unbiased MMD^2 with
    the polynomial kernel k(x,y) = (x.y/d + 1)^3 over feature subsets drawn
    from ``np.random.default_rng(seed)``. Returns (mean, std) over subsets."""
    rng = np.random.default_rng(seed)
    d = real_feats.shape[1]
    n = min(subset_size, len(real_feats), len(fake_feats))
    scores = []
    for _ in range(num_subsets):
        x = real_feats[rng.choice(len(real_feats), n, replace=False)].astype(np.float64)
        y = fake_feats[rng.choice(len(fake_feats), n, replace=False)].astype(np.float64)
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        np.fill_diagonal(kxx, 0.0)
        np.fill_diagonal(kyy, 0.0)
        mmd = kxx.sum() / (n * (n - 1)) + kyy.sum() / (n * (n - 1)) - 2.0 * kxy.mean()
        scores.append(mmd)
    return float(np.mean(scores)), float(np.std(scores))


def inception_score(probs: np.ndarray, splits: int = 10) -> tuple:
    """IS = exp(E_x KL(p(y|x) || p(y))) over class-probability rows."""
    scores = []
    n = len(probs)
    for k in range(splits):
        part = probs[k * n // splits: (k + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(0, keepdims=True)
        kl = (part * (np.log(part + 1e-12) - np.log(py + 1e-12))).sum(1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def pairwise_l2(a: np.ndarray, b: np.ndarray, block: int = 512) -> np.ndarray:
    """[len(a), len(b)] float64 L2 distances, computed in row blocks so the
    peak temporary is [block, len(b), D]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.ndim == b.ndim == 2 and a.shape[1] == b.shape[1], (a.shape, b.shape)
    out = np.empty((len(a), len(b)), np.float64)
    for i in range(0, len(a), block):
        out[i:i + block] = np.linalg.norm(a[i:i + block, None] - b[None], axis=-1)
    return out


def density_coverage(real_feats: np.ndarray, fake_feats: np.ndarray, k: int = 5,
                     d_rr: Optional[np.ndarray] = None,
                     d_fr: Optional[np.ndarray] = None) -> tuple:
    """Density & coverage (Naeem et al. 2020, arXiv:2002.09797): density
    counts the real k-NN balls each fake falls inside (fidelity-like, can
    exceed 1), coverage is the fraction of real balls holding a fake
    (diversity-like, in [0, 1])."""
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)
    assert real.ndim == fake.ndim == 2 and real.shape[1] == fake.shape[1]
    assert 1 <= k < len(real), (k, len(real))
    if d_rr is None:
        d_rr = pairwise_l2(real, real)  # [N, N]
    if d_fr is None:
        d_fr = pairwise_l2(fake, real)  # [M, N]
    # k-th NN radius per real point (excluding self: column 0 is 0)
    radii = np.sort(d_rr, axis=1)[:, k]
    inside = d_fr <= radii[None]  # fake j inside real i's ball
    density = float(inside.sum() / (k * len(fake)))
    coverage = float(inside.any(axis=0).mean())
    return density, coverage


def precision_recall(real_feats: np.ndarray, fake_feats: np.ndarray, k: int = 3,
                     d_rr: Optional[np.ndarray] = None,
                     d_fr: Optional[np.ndarray] = None) -> tuple:
    """Improved precision & recall (Kynkäänniemi et al. 2019,
    arXiv:1904.06991): the fraction of fakes inside the union of the real
    k-NN balls, and of reals inside the fakes' balls."""
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)
    assert real.ndim == fake.ndim == 2 and real.shape[1] == fake.shape[1]
    assert 1 <= k < min(len(real), len(fake)), (k, len(real), len(fake))
    if d_rr is None:
        d_rr = pairwise_l2(real, real)
    if d_fr is None:
        d_fr = pairwise_l2(fake, real)  # [M, N]
    d_ff = pairwise_l2(fake, fake)
    radii_r = np.sort(d_rr, axis=1)[:, k]  # self-distance occupies col 0
    radii_f = np.sort(d_ff, axis=1)[:, k]
    precision = float((d_fr <= radii_r[None]).any(axis=1).mean())
    recall = float((d_fr.T <= radii_f[None]).any(axis=1).mean())
    return precision, recall


def gradient_energy(images: np.ndarray) -> float:
    """Mean squared finite-difference gradient magnitude per pixel: a noise
    and sharpness statistic the feature metrics miss."""
    x = np.asarray(images, np.float64)
    assert x.ndim == 4, x.shape  # [N, H, W, C]
    gx = np.diff(x, axis=2)
    gy = np.diff(x, axis=1)
    return float((gx ** 2).mean() + (gy ** 2).mean())


def radial_power_profile(images: np.ndarray, n_bins: int = 32) -> np.ndarray:
    """Radially averaged log10 power spectrum, [n_bins]: the 2-D FFT power
    of each image binned by spatial-frequency radius, averaged over images
    and channels."""
    x = np.asarray(images, np.float64)
    assert x.ndim == 4, x.shape
    n, h, w, c = x.shape
    spec = np.abs(np.fft.fft2(x, axes=(1, 2))) ** 2  # [N, H, W, C]
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    r = np.sqrt(fy ** 2 + fx ** 2)  # [H, W] in cycles/pixel, max ~0.707
    bins = np.minimum((r / (0.5 * np.sqrt(2.0)) * n_bins).astype(int), n_bins - 1)
    prof = np.zeros(n_bins)
    counts = np.zeros(n_bins)
    np.add.at(prof, bins.reshape(-1), spec.mean(axis=(0, 3)).reshape(-1))
    np.add.at(counts, bins.reshape(-1), 1.0)
    return np.log10(prof / np.maximum(counts, 1.0) + 1e-12)


def spectral_distance(real: np.ndarray, fake: np.ndarray, n_bins: int = 32) -> float:
    """RMSE between the radially averaged log power spectra of two image
    stacks: 0 for matched frequency content."""
    pr = radial_power_profile(real, n_bins)
    pf = radial_power_profile(fake, n_bins)
    return float(np.sqrt(np.mean((pr - pf) ** 2)))
