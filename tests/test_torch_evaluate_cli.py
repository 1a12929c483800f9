"""The port's evaluation CLI (python -m eo_diffusion_torch.cli.evaluate)
against eo_diffusion_tpu.cli.evaluate on two small PNG directories, on the
CPU: the same images, the same keys, and the same values. With one numpy
extractor on both sides every value is equal to the bit; with each
package's offline extractor (float32 features that differ in their last
bits) the feature statistics agree within 1e-5 relative and the rest to the
bit. No jitted JAX function."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from eo_diffusion_torch.cli import evaluate as T
from eo_diffusion_tpu.cli import evaluate as J
from torch_parity import one_torch_thread  # noqa: F401

FEATURE_KEYS = ("frechet_distance", "kid_mean", "kid_std")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """12 real and 10 fake 16 px PNGs (seeded), plus one larger real image,
    which the loader crops to the common size."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    real = rng.integers(0, 256, (12, 16, 16, 3), np.uint8)
    fake = np.clip(real[:10].astype(int) + rng.integers(-40, 41, (10, 16, 16, 3)), 0,
                   255).astype(np.uint8)
    for name, imgs in (("real", real), ("fake", fake)):
        os.makedirs(root / name)
        for i, im in enumerate(imgs):
            Image.fromarray(im).save(root / name / f"{i:02d}.png")
    Image.fromarray(rng.integers(0, 256, (20, 18, 3), np.uint8)).save(root / "real" / "zz.jpg")
    return root


def test_load_image_dir_matches_jax(dirs):
    for name, limit in (("real", 0), ("fake", 4)):
        got = T.load_image_dir(str(dirs / name), limit)
        np.testing.assert_array_equal(got, J.load_image_dir(str(dirs / name), limit))
    assert T.load_image_dir(str(dirs / "real")).shape == (13, 16, 16, 3)
    with pytest.raises(FileNotFoundError):
        T.load_image_dir(str(dirs / "nothing"))


def test_compute_metrics_with_one_extractor_equals_jax_to_the_bit(dirs):
    real, fake = (T.load_image_dir(str(dirs / n)) for n in ("real", "fake"))
    ext = lambda x: np.asarray(x, np.float32).reshape(len(x), -1)[:, ::37].copy()
    got = T.compute_metrics(real, fake, extractor=ext, batch=5)
    assert got == J.compute_metrics(real, fake, extractor=ext, batch=5)
    # with class probabilities: the inception score of the fake stack too
    probs = lambda x: (ext(x), np.full((len(x), 4), 0.25) + np.arange(len(x))[:, None] * 1e-3)
    got = T.compute_metrics(real, fake, extractor=probs, batch=4, with_logits=True)
    assert "inception_score" in got
    assert got == J.compute_metrics(real, fake, extractor=probs, batch=4, with_logits=True)


def test_compute_metrics_with_the_offline_extractor_matches_jax(dirs):
    real, fake = (T.load_image_dir(str(dirs / n)) for n in ("real", "fake"))
    want = J.compute_metrics(real, fake, batch=5)
    got = T.compute_metrics(real, fake, batch=5, device="cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        if k in FEATURE_KEYS:
            assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)


def test_main_writes_the_json_and_the_inception_extractor_needs_weights(dirs, tmp_path,
                                                                       monkeypatch):
    out = tmp_path / "m" / "metrics.json"
    res = T.main(T.parse_args(["--real", str(dirs / "real"), "--fake", str(dirs / "fake"),
                               "--limit", "10", "--out", str(out), "--device", "cpu"]))
    assert json.loads(out.read_text()) == res and res["n_real"] == res["n_fake"] == 10
    monkeypatch.delenv("EO_INCEPTION_WEIGHTS", raising=False)
    argv = ["--real", str(dirs / "real"), "--fake", str(dirs / "fake"), "--device", "cpu",
            "--extractor", "inception"]
    for extra in ([], ["--inception_weights", str(tmp_path / "missing.pth")]):
        with pytest.raises(SystemExit, match="needs --inception_weights"):
            T.main(T.parse_args(argv + extra))
    monkeypatch.setenv("EO_INCEPTION_WEIGHTS", str(tmp_path / "missing.pth"))
    assert T.parse_args(argv).inception_weights == str(tmp_path / "missing.pth")


def test_inception_extractor_through_main(dirs, tmp_path, monkeypatch):
    """``--extractor inception`` wires the loaded model through the
    extractor into FID + IS: a stand-in for the 299 px network (the real one
    is held against JAX in tests/test_torch_inception.py) records what it
    sees."""
    from eo_diffusion_torch.models import inception as I

    seen = []

    class StandIn(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3, 5))

        def forward(self, x):
            seen.append(tuple(x.shape))
            pool = x.mean(dim=(1, 2))
            return {"pool3": pool.repeat(1, 4), "logits": pool @ self.w}

    path = tmp_path / "inception.pth"
    path.write_bytes(b"")
    monkeypatch.setattr(I, "load_torch_inception",
                        lambda p, device=None: StandIn().to(device).eval())
    res = T.main(T.parse_args(["--real", str(dirs / "real"), "--fake", str(dirs / "fake"),
                               "--limit", "6", "--device", "cpu", "--extractor", "inception",
                               "--inception_weights", str(path), "--batch", "4"]))
    assert seen == [(4, 299, 299, 3), (2, 299, 299, 3)] * 2
    assert res["n_fake"] == 6 and res["inception_score"] == pytest.approx(1.0)


def test_no_gpu_without_device_cpu_fails_clearly(dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default --device cuda is valid")
    with pytest.raises(SystemExit, match="no CUDA device"):
        T.main(T.parse_args(["--real", str(dirs / "real"), "--fake", str(dirs / "fake")]))
