"""The port's native data library (GeoTIFF decoder and patch sampler, built
with g++ into eo_diffusion_torch/_build/) on the CPU: decodes of every layout
the JAX package's TIFF tests write, the patch sampler against the JAX
package's plain version, the cached-tile dataset, the sen12mscr factory over
real GeoTIFF bytes, the failure of a broken build, and both CLIs trained and
sampled from a GeoTIFF tree."""

import os
import stat

import numpy as np
import pytest
import torch

from eo_diffusion_torch.data import native
from eo_diffusion_torch.data import sen12ms_cr as PS
from eo_diffusion_torch.data import tile_cache as PTC
from eo_diffusion_torch.data.factories import create_sen12mscr_dataloaders
from eo_diffusion_tpu.data import factories as JF
from eo_diffusion_tpu.data import native as JN
from eo_diffusion_tpu.data import tile_cache as JTC
from tests.test_tiff_native import _rand, write_tiff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def lib():
    """The port's library, built once (the build is keyed by its sources)."""
    return native.build_native()


def test_the_library_is_the_ports_own_build(lib):
    assert native.loaded_path() == str(lib) == str(native.library_path())
    assert os.path.dirname(str(lib)) == os.path.join(ROOT, "eo_diffusion_torch", "_build")
    assert native._load().eo_version() == 1


DECODE = {
    "13band_uint16_strips": ((21, 17, 13), np.uint16, dict(rows_per_strip=5)),
    "uint8": ((9, 7, 3), np.uint8, {}),
    "int16": ((9, 7, 3), np.int16, {}),
    "float32_two_bands": ((9, 7, 2), np.float32, dict(rows_per_strip=4)),
    "int32": ((5, 6, 1), np.int32, {}),
    "deflate": ((16, 16, 4), np.uint16, dict(compression=8, rows_per_strip=6)),
    "deflate_predictor2": ((12, 11, 2), np.uint16, dict(compression=8, predictor=2,
                                                         rows_per_strip=4)),
    "deflate_predictor2_uint8": ((12, 11, 3), np.uint8, dict(compression=8, predictor=2)),
    "planar_deflate": ((10, 8, 5), np.uint16, dict(planar=2, rows_per_strip=3,
                                                    compression=8)),
    "tiled_deflate": ((20, 30, 3), np.uint16, dict(tile=(16, 16), compression=8)),
    "tiled_planar_bigendian": ((17, 19, 4), np.uint16, dict(tile=(16, 16), planar=2,
                                                             big_endian=True)),
    "bigendian_strips": ((6, 5, 13), np.uint16, dict(big_endian=True, rows_per_strip=2)),
    "bigendian_deflate_predictor2": ((7, 9, 13), np.uint16, dict(
        big_endian=True, compression=8, predictor=2, rows_per_strip=3)),
}


@pytest.mark.parametrize("case", sorted(DECODE))
def test_decode_equals_the_written_raster(tmp_path, case):
    shape, dtype, kw = DECODE[case]
    a = _rand(shape, dtype, seed=len(case))
    p = str(tmp_path / "x.tif")
    write_tiff(p, a, **kw)
    meta = native.tiff_info(p)
    assert (meta["height"], meta["width"], meta["samples"]) == shape
    assert meta["bits"] == 8 * np.dtype(dtype).itemsize
    assert meta["compression"] == kw.get("compression", 1)
    assert meta["planar"] == kw.get("planar", 1)
    got = native.read_tiff(p)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, a.astype(np.float32))


def test_lzw_decode_agrees_with_pil(tmp_path):
    from PIL import Image

    base = np.linspace(0, 255, 24 * 32 * 3).reshape(24, 32, 3)
    a = (base + np.random.default_rng(8).integers(0, 8, (24, 32, 3))).clip(0, 255)
    a = a.astype(np.uint8)
    p = str(tmp_path / "lzw.tif")
    Image.fromarray(a).save(p, compression="tiff_lzw")
    assert native.tiff_info(p)["compression"] == 5
    np.testing.assert_array_equal(native.read_tiff(p), a.astype(np.float32))


def test_unsupported_and_broken_files_raise(tmp_path):
    p = str(tmp_path / "p2.tif")
    write_tiff(p, np.arange(72, dtype=np.float32).reshape(6, 6, 2), compression=8,
               predictor=2, rows_per_strip=3)
    with pytest.raises(ValueError, match="unsupported"):
        native.read_tiff(p)
    (tmp_path / "x.tif").write_bytes(b"PNG whatever")
    with pytest.raises(ValueError, match="not a classic TIFF"):
        native.tiff_info(str(tmp_path / "x.tif"))
    with pytest.raises(ValueError, match="cannot open"):
        native.tiff_info(str(tmp_path / "nope.tif"))


@pytest.mark.parametrize("dtype,threads", [(np.uint8, 0), (np.uint8, 1), (np.float32, 3),
                                           (np.uint16, 0)])
def test_extract_patches_matches_the_plain_version(dtype, threads):
    rng = np.random.default_rng(0)
    tiles = (rng.integers(0, 255, (3, 20, 17, 4)) if dtype != np.float32
             else rng.normal(size=(3, 20, 17, 4))).astype(dtype)
    jobs = np.array([[t, r, c, f] for t in range(3) for r, c in ((0, 0), (12, 9), (5, 3))
                     for f in range(4)], np.int64)
    got = native.extract_patches(tiles, jobs, 8, 2 / 255, -1.0, n_threads=threads)
    np.testing.assert_array_equal(got, JN._extract_numpy(tiles, jobs, 8, 2 / 255, -1.0))
    np.testing.assert_array_equal(
        got, native.extract_patches(tiles, jobs, 8, 2 / 255, -1.0, force_numpy=True))
    with pytest.raises(ValueError, match="outside"):
        native.extract_patches(tiles, np.array([[0, 13, 0, 0]]), 8)


def test_cached_tile_dataset_matches_jax():
    rng = np.random.default_rng(1)
    tiles = rng.integers(0, 255, (2, 40, 36, 3)).astype(np.uint8)
    masks = rng.integers(0, 2, (2, 40, 36, 1)).astype(np.uint8) * 255
    kw = dict(masks=masks, labels=[3, 1], size=16, overlap=0.25, data_range=(-1.0, 1.0),
              augment_flips=True, seed=5)
    p, j = PTC.CachedTileDataset(tiles, **kw), JTC.CachedTileDataset(tiles, **kw)
    assert len(p) == len(j) == 2 * 3 * 2
    for i in range(len(j)):  # each item draws its flips
        got, want = p[i], j[i]
        assert sorted(got) == sorted(want) == ["class", "image", "segmentation"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    got, want = p.get_batch([0, 7, 3, 11]), j.get_batch([0, 7, 3, 11])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def write_sen12_tree(root, size=8, scenes=(10, 42), patches=range(3)):
    """A SEN12MS-CR tree of real GeoTIFF bytes: s1 2 bands float32, s2 and
    s2_cloudy 13 bands uint16 (deflate with the predictor for s2_cloudy).
    Returns {path: written array}."""
    season = PS.Seasons.SUMMER.value
    rng = np.random.default_rng(0)
    written = {}
    for scene in scenes:
        for sensor, bands, dtype in (("s1", 2, np.float32), ("s2", 13, np.uint16),
                                     ("s2_cloudy", 13, np.uint16)):
            d = os.path.join(root, season, f"{sensor}_{scene}")
            os.makedirs(d, exist_ok=True)
            for pid in patches:
                arr = (rng.integers(0, 12000, (size, size, bands)).astype(dtype)
                       if dtype is np.uint16 else
                       rng.normal(-10, 3, (size, size, bands)).astype(dtype))
                path = os.path.join(d, f"{season}_{sensor}_{scene}_p{pid}.tif")
                deflate = sensor == "s2_cloudy"
                write_tiff(path, arr, rows_per_strip=4, compression=8 if deflate else 1,
                           predictor=2 if deflate else 1)
                written[path] = arr
    return written


def test_default_reader_is_the_native_decoder(tmp_path):
    written = write_sen12_tree(str(tmp_path), patches=(1,), scenes=(5,))
    for path, arr in written.items():
        bands = [4, 3, 2] if arr.shape[-1] == 13 else [1, 2]
        np.testing.assert_array_equal(PS._default_reader(path, bands),
                                      arr.astype(np.float32)[:, :, [b - 1 for b in bands]])


def test_sen12mscr_factory_over_geotiffs_matches_jax(tmp_path):
    written = write_sen12_tree(str(tmp_path))
    reader = lambda path, bands: written[path].astype(np.float32)[:, :, [b - 1 for b in bands]]
    ptr, pte = create_sen12mscr_dataloaders(2, root=str(tmp_path))  # the native decoder
    jtr, jte = JF.create_sen12mscr_dataloaders(2, root=str(tmp_path), reader=reader)
    for (a, b) in ((next(iter(ptr)), next(iter(jtr))), (next(iter(pte)), next(iter(jte)))):
        assert sorted(a) == sorted(b) == ["cond_image", "image", "sar"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert next(iter(ptr))["image"].max() > 0.1  # decoded numbers, not zeros


def test_a_failed_build_raises_and_nothing_stands_in(tmp_path, monkeypatch):
    """A compiler that cannot find zlib's header: the build raises naming
    zlib, and the SEN12MS-CR reader raises too instead of passing the file
    to tifffile or PIL."""
    fake = tmp_path / "fake-g++"
    fake.write_text("#!/bin/sh\necho 'tiff_reader.cc:30:10: fatal error: zlib.h: "
                    "No such file or directory' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    tif = str(tmp_path / "x.tif")
    write_tiff(tif, _rand((4, 4, 3), np.uint8))
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    native._target.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="zlib"):
            native.build_native()
        assert not native.have_native()
        with pytest.raises(RuntimeError, match="zlib"):
            PS._default_reader(tif, [1, 2, 3])
        assert not list((tmp_path / "build").glob("*.so*"))
    finally:
        native._target.cache_clear()


def test_clis_train_and_sample_from_a_geotiff_tree(tmp_path, monkeypatch):
    """cli.train on the tiny concat preset takes 2 steps from the tree, the
    first batch it sees is the loader's; cli.inference then samples from its
    checkpoint, conditioned on the test split's cloudy views."""
    from eo_diffusion_torch.cli import inference, train
    from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
    from eo_diffusion_torch.train import trainer as TR

    tree = str(tmp_path / "SEN12MS_CR")
    write_sen12_tree(tree, patches=range(8))  # 16 triplets: 14 train, 2 test
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(1)
    seen = []
    real_step = TR.Trainer.step
    monkeypatch.setattr(TR.Trainer, "step", lambda self, state, batch: (
        seen.append({k: v.clone() for k, v in batch.items()}), real_step(self, state, batch))[1])
    res = train.main(train.parse_args([
        "--preset", "tiny-cr", "--dataset", "sen12mscr", "--data_root", tree, "--device", "cpu",
        "--epochs", "1", "--steps_per_epoch", "2", "--batch_size", "4", "--sample_every", "0",
        "--save_every", "0", "--log_freq", "1", "--dir", "results/t"]))
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))
    assert len(res["wait_seconds"]) == 2
    first = next(iter(create_sen12mscr_dataloaders(4, root=tree)[0]))
    assert sorted(seen[0]) == ["cond", "image"]
    np.testing.assert_array_equal(seen[0]["image"].numpy(), first["image"])
    np.testing.assert_array_equal(seen[0]["cond"].numpy(), first["cond_image"])

    conds = []
    real_ddim = GaussianDiffusion.ddim_sample
    monkeypatch.setattr(GaussianDiffusion, "ddim_sample", lambda self, *a, **kw: (
        conds.append(kw["cond"].clone()), real_ddim(self, *a, **kw))[1])
    out = inference.main(inference.parse_args([
        "--preset", "tiny-cr", "--dataset", "sen12mscr", "--data_root", tree, "--device",
        "cpu", "--sampler", "ddim", "--sampler_steps", "2", "--n_iter", "0", "--batch_size",
        "2", "--ckpt", res["checkpoint"], "--outdir", str(tmp_path / "out")]))
    x = torch.as_tensor(out["samples"])
    assert x.shape == (2, 8, 8, 3) and bool(torch.isfinite(x).all())
    test_batch = next(iter(create_sen12mscr_dataloaders(2, root=tree, test=True)[1]))
    np.testing.assert_array_equal(conds[0].numpy(), test_batch["cond_image"])
