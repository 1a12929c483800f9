"""The port's evaluation metrics (eo_diffusion_torch.utils.metrics) against
eo_diffusion_tpu's on seeded inputs, on the CPU: SSIM, PSNR, the bilinear
resize and the offline extractor in float32 within 1e-5 relative, at 8 px
(SSIM's window clamped to 7) and 64 px; the host-side statistics (KID, IS,
PRDC, the gradient and spectral guards) on the same features to the bit;
the Frechet distance within 1e-6 relative. No jitted JAX function: the JAX
metrics run eagerly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.utils import metrics as T
from eo_diffusion_tpu.utils import metrics as J
from torch_parity import one_torch_thread  # noqa: F401

REL_TOL = 1e-5


def _pair(size, seed=0, n=3):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(size=(n, size, size, 3)).astype(np.float32)
    target = np.clip(pred + 0.1 * rng.normal(size=pred.shape), 0, 1).astype(np.float32)
    return pred, target


def _feats(seed, n, d=16):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("size", [8, 64])
def test_ssim_and_psnr_match_jax(size):
    pred, target = _pair(size)
    for fn_t, fn_j in ((T.ssim, J.ssim), (T.psnr, J.psnr)):
        want = float(fn_j(jnp.asarray(pred), jnp.asarray(target)))
        got = fn_t(torch.from_numpy(pred), torch.from_numpy(target))
        assert got.dtype == torch.float32 and got.ndim == 0
        assert abs(float(got) - want) <= REL_TOL * abs(want), (fn_t.__name__, float(got), want)
    # numpy inputs and a data range of 2 ([-1, 1] images)
    want = float(J.ssim(jnp.asarray(pred * 2 - 1), jnp.asarray(target * 2 - 1), data_range=2.0))
    assert abs(float(T.ssim(pred * 2 - 1, target * 2 - 1, data_range=2.0)) - want) <= (
        REL_TOL * abs(want))


def test_ssim_of_an_image_with_itself_is_one_and_psnr_is_capped():
    pred, _ = _pair(16)
    assert float(T.ssim(pred, pred)) == pytest.approx(1.0, abs=1e-6)
    assert float(T.psnr(pred, pred)) == pytest.approx(120.0)  # the 1e-12 MSE floor


@pytest.mark.parametrize("shape", [(64, 64, 16, 16), (8, 8, 16, 16), (75, 75, 299, 299),
                                   (20, 13, 7, 16), (16, 16, 16, 9)])
def test_resize_bilinear_matches_jax_image_resize(shape):
    """Down (anti-aliased), up, mixed and one dimension left alone."""
    h, w, oh, ow = shape
    x = np.random.default_rng(1).uniform(size=(2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, oh, ow, 3), "bilinear"))
    got = T.resize_bilinear(torch.from_numpy(x), oh, ow).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("size", [8, 64])
def test_tiny_feature_extractor_matches_jax(size):
    pred, target = _pair(size, seed=2, n=4)
    ext_t, ext_j = T.tiny_feature_extractor(), J.tiny_feature_extractor()
    for batch in (pred, target):  # the projection drawn at the first call stays
        want = np.asarray(ext_j(jnp.asarray(batch)))
        got = ext_t(batch)
        assert got.dtype == np.float32 and got.shape == want.shape == (4, 192)
        assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def test_frechet_distance_matches_jax():
    real, fake = _feats(3, 40), _feats(4, 30) + 0.3
    fd_t, fd_j = T.FrechetDistance(lambda x: x), J.FrechetDistance(lambda x: x)
    for fd in (fd_t, fd_j):
        fd.add_real_feats(real[:20])
        fd.add_real_feats(real[20:])
        fd.add_fake_feats(fake)
    want = fd_j.compute()
    assert abs(fd_t.compute() - want) <= 1e-6 * abs(want)
    # the streaming path through an extractor, fed tensors on the port's side
    fd_t = T.FrechetDistance(lambda x: x * 2)
    fd_t.update_real(torch.from_numpy(real))
    fd_t.update_fake(fake)
    assert abs(fd_t.compute() - 4 * want) <= 1e-6 * abs(4 * want)


def test_frechet_distance_regularises_a_product_without_a_finite_root(monkeypatch):
    """Where ``sqrtm`` of the covariances' product is not finite (newer
    SciPy on a singular product), the covariances get 1e-6 on the diagonal
    (torch-fidelity's remedy); a finite root is used as it is."""
    import scipy.linalg

    real, fake = _feats(11, 6, d=10), _feats(12, 5, d=10)  # fewer samples than dims
    mu1, cov1 = T.FrechetDistance._stats(real)
    mu2, cov2 = T.FrechetDistance._stats(fake)
    want_plain = J.FrechetDistance.frechet(mu1, cov1, mu2, cov2)
    assert T.FrechetDistance.frechet(mu1, cov1, mu2, cov2) == want_plain
    real_sqrtm = scipy.linalg.sqrtm
    singular = cov1 @ cov2

    def sqrtm(m, **kw):
        if np.array_equal(m, singular):
            return np.full_like(m, np.nan), np.inf
        return real_sqrtm(m, **kw)

    monkeypatch.setattr(scipy.linalg, "sqrtm", sqrtm)
    eye = np.eye(10) * 1e-6
    root = real_sqrtm((cov1 + eye) @ (cov2 + eye), disp=False)[0].real
    diff = mu1 - mu2
    want = float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(root))
    got = T.FrechetDistance.frechet(mu1, cov1, mu2, cov2)
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-12)


def test_kid_and_inception_score_to_the_bit():
    real, fake = _feats(5, 50), _feats(6, 45) * 1.1
    for kw in ({}, dict(subset_size=10, num_subsets=7, seed=3)):
        assert T.kid(real, fake, **kw) == J.kid(real, fake, **kw)
    logits = _feats(7, 37, d=10)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    assert T.inception_score(probs) == J.inception_score(probs)
    assert T.inception_score(probs, splits=4) == J.inception_score(probs, splits=4)


def test_prdc_to_the_bit():
    real, fake = _feats(8, 30), _feats(9, 25) + 0.2
    np.testing.assert_array_equal(T.pairwise_l2(fake, real, block=7), J.pairwise_l2(fake, real))
    assert T.density_coverage(real, fake) == J.density_coverage(real, fake)
    assert T.density_coverage(real, fake, k=2) == J.density_coverage(real, fake, k=2)
    assert T.precision_recall(real, fake) == J.precision_recall(real, fake)
    d_rr, d_fr = T.pairwise_l2(real, real), T.pairwise_l2(fake, real)
    assert T.precision_recall(real, fake, k=4, d_rr=d_rr, d_fr=d_fr) == J.precision_recall(
        real, fake, k=4)


@pytest.mark.parametrize("size", [8, 64])
def test_gradient_and_spectral_guards_to_the_bit(size):
    real, fake = _pair(size, seed=10, n=5)
    assert T.gradient_energy(fake) == J.gradient_energy(fake)
    np.testing.assert_array_equal(T.radial_power_profile(real), J.radial_power_profile(real))
    np.testing.assert_array_equal(T.radial_power_profile(real, 7),
                                  J.radial_power_profile(real, 7))
    assert T.spectral_distance(real, fake) == J.spectral_distance(real, fake)
