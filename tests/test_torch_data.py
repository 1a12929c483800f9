"""The port's data feed against the JAX package's, on the CPU: transforms,
patch math, every dataset class on tiny trees written here, the loader
(shuffle, shard, transforms, worker threads, prefetch, drop_last, resume),
every dataset factory, the device cache's gather and the patch exporter.
Both packages are numpy here, so the comparisons are bit for bit."""

import gzip
import os
import pickle
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.data import datasets as PD
from eo_diffusion_torch.data import device_cache as PC
from eo_diffusion_torch.data import factories as PF
from eo_diffusion_torch.data import loader as PL
from eo_diffusion_torch.data import patches as PP
from eo_diffusion_torch.data import sen12ms_cr as PS
from eo_diffusion_torch.data import transforms as PT
from eo_diffusion_tpu.data import datasets as JD
from eo_diffusion_tpu.data import device_cache as JC
from eo_diffusion_tpu.data import factories as JF
from eo_diffusion_tpu.data import loader as JL
from eo_diffusion_tpu.data import patches as JP
from eo_diffusion_tpu.data import sen12ms_cr as JS
from eo_diffusion_tpu.data import transforms as JT


def assert_same(a, b):
    """Two items or batches: the same keys, dtypes and values."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def assert_datasets_equal(p, j):
    assert len(p) == len(j) > 0
    assert tuple(p.data_range) == tuple(j.data_range)
    for i in range(len(j)):
        assert_same(p[i], j[i])


# ---------------------------------------------------------------------------
# transforms and patches
# ---------------------------------------------------------------------------

TRANSFORMS = {
    "hflip": lambda M: M.RandomHorizontalFlip(),
    "vflip": lambda M: M.RandomVerticalFlip(p=0.7),
    "solarize": lambda M: M.RandomSolarize(0.5, p=0.6, img_channels=2),
    "sharpness_blur": lambda M: M.RandomAdjustSharpness(0.3, p=0.7, img_channels=3),
    "sharpness_sharpen": lambda M: M.RandomAdjustSharpness(1.5, p=0.7),
    "normalize": lambda M: M.Normalize(0.5, 0.5, img_channels=3),
    "center_crop": lambda M: M.CenterCrop(6),
    "center_crop_pad": lambda M: M.CenterCrop(12),
    "resize_bilinear": lambda M: M.Resize(13),
    "resize_nearest": lambda M: M.Resize(5, method="nearest"),
    "compose": lambda M: M.Compose([M.RandomHorizontalFlip(), M.RandomVerticalFlip(),
                                    M.RandomSolarize(0.4, p=0.5, img_channels=3)]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    x = np.random.default_rng(0).uniform(0, 1, (9, 10, 4)).astype(np.float32)
    tp, tj = TRANSFORMS[name](PT), TRANSFORMS[name](JT)
    rp, rj = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(6):  # several draws from one generator
        assert_same(tp(x, rp), tj(x, rj))
    assert rp.random() == rj.random()  # the same number of draws taken


def test_mask_and_sr_helpers_match_jax():
    for seed in range(4):
        assert_same(PT.random_rect_mask((32, 24), 10, 10, 40, 45, np.random.default_rng(seed)),
                    JT.random_rect_mask((32, 24), 10, 10, 40, 45, np.random.default_rng(seed)))
    img = np.random.default_rng(1).normal(size=(2, 8, 12, 3)).astype(np.float32)
    for f in (1, 2, 4):
        assert_same(PT.sr_degrade(img, f), JT.sr_degrade(img, f))
        assert_same(PT.sr_cond(img, f), JT.sr_cond(img, f))
        assert_same(PT.sr_cond(img[0], f), JT.sr_cond(img[0], f))


def test_patch_math_matches_jax():
    img = np.random.default_rng(0).normal(size=(40, 36, 3)).astype(np.float32)
    for size, step in ((16, 8), (8, 3), (36, 1)):
        gp, gj = PP.grid_patches(img, size, step), JP.grid_patches(img, size, step)
        assert_same(gp, gj)
        for num in (0, 1, 5, 1000):
            assert_same(PP.subsample_patches(gp, num), JP.subsample_patches(gj, num))
    for orig, size, step in (((1022, 1022), 64, 64), ((100, 70), 32, 16), ((20, 20), 32, 8)):
        for overhang in (False, True):
            nw = PP.num_windows(orig, size, step, overhang)
            assert nw == JP.num_windows(orig, size, step, overhang)
            for p in range(nw[0] * nw[1]):
                for clamp in (False, True):
                    assert (PP.window_index(p, orig, size, step, nw[1], clamp)
                            == JP.window_index(p, orig, size, step, nw[1], clamp))


# ---------------------------------------------------------------------------
# tiny dataset trees (the layouts of tests/test_data.py's fixtures)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from PIL import Image
    import pandas as pd

    base = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(0)
    out = {}

    # MNIST raw IDX files, train (plain) and t10k (gzip)
    mnist = base / "mnist"
    mnist.mkdir()
    for kind, n, opener, ext in (("train", 12, open, ""), ("t10k", 6, gzip.open, ".gz")):
        imgs = rng.integers(0, 255, (n, 28, 28), np.uint8)
        lbls = rng.integers(0, 10, n).astype(np.uint8)
        with opener(mnist / f"{kind}-images-idx3-ubyte{ext}", "wb") as f:
            f.write(b"\x00\x00\x08\x03" + np.array(imgs.shape, ">i4").tobytes() + imgs.tobytes())
        with opener(mnist / f"{kind}-labels-idx1-ubyte{ext}", "wb") as f:
            f.write(b"\x00\x00\x08\x01" + np.array([n], ">i4").tobytes() + lbls.tobytes())
    out["mnist"] = str(mnist)

    # CIFAR-10 python pickles
    cifar = base / "cifar" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.integers(0, 255, (3, 3072), np.uint8),
             b"labels": list(rng.integers(0, 10, 3).tolist())}
        with open(cifar / name, "wb") as f:
            pickle.dump(d, f)
    out["cifar10"] = str(base / "cifar")

    # Inria: RGB tiles + building masks
    inria = base / "inria"
    for sub in ("train/images", "train/gt"):
        (inria / sub).mkdir(parents=True)
    for city in ("austin1", "kitsap2", "vienna3"):
        Image.fromarray(rng.integers(0, 255, (96, 80, 3), np.uint8)).save(
            inria / "train/images" / f"{city}.tif")
        Image.fromarray((rng.uniform(0, 1, (96, 80)) > 0.5).astype(np.uint8) * 255).save(
            inria / "train/gt" / f"{city}.tif")
    out["inria"] = str(inria)

    # Sentinel-2 Cloud Mask Catalogue: .npy tiles + the tags CSV (written by
    # pandas, as the JAX package reads it); sceneC fails snow/ice, sceneD has
    # an empty clear_percent, sceneE carries none of the default classes
    cmc = base / "cmc"
    (cmc / "subscenes").mkdir(parents=True)
    (cmc / "masks").mkdir()
    rows = []
    for i, name in enumerate(["sceneA", "sceneB", "sceneC", "sceneD", "sceneE"]):
        np.save(cmc / "subscenes" / f"{name}.npy",
                rng.uniform(0, 1.2, (1022, 1022, 4)).astype(np.float32))
        np.save(cmc / "masks" / f"{name}.npy",
                (rng.uniform(0, 1, (1022, 1022, 2)) > 0.5).astype(np.float32))
        rows.append(dict(index=i, scene=name, **{"snow/ice": int(i == 2)},
                         clear_percent=None if i == 3 else 60, cloud_percent=30,
                         agricultural=int(i != 4), **{"urban/developed": int(i == 1),
                                                      "hills/mountains": 0}))
    pd.DataFrame(rows).to_csv(cmc / "classification_tags.csv", index=False)
    out["clouds"] = str(cmc)

    # OSCD: t1/t2 rectified RGB crops and change labels, train and test
    oscd = base / "oscd"
    for split in ("train", "test"):
        d = oscd / "OSCD_64_32" / split
        d.mkdir(parents=True)
        for i in range(5):
            for pat in ("imgs_1_rect-rgb", "imgs_2_rect-rgb", "lbl"):
                Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
                    d / f"p{i}_{pat}.png")
    out["oscd"] = str(oscd)

    # SAR wakes: variable-size grayscale tiles listed in a CSV per split
    sar = base / "sarwake"
    for split, csv_name in (("train2017", "train_csv.csv"), ("val2017", "val_csv.csv")):
        (sar / split).mkdir(parents=True)
        names = []
        for i, (h, w) in enumerate(((70, 90), (64, 64), (100, 41))):
            name = f"{split}_{i}.png"
            Image.fromarray(rng.integers(0, 255, (h, w), np.uint8)).save(sar / split / name)
            names.append(name)
        pd.DataFrame({"filename": names, "other": [1, 2, 3]}).to_csv(sar / split / csv_name,
                                                                     index=False)
    out["sarwake"] = str(sar)

    # EuroSAT: one folder of JPEGs per class
    euro = base / "eurosat"
    for cls in ("Forest", "River", "SeaLake"):
        (euro / cls).mkdir(parents=True)
        for j in range(4):
            Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
                euro / cls / f"{cls}_{j}.jpg")
    out["eurosat"] = str(euro)

    # SEN12MS-CR: empty files (the reader is injected) in the season layout
    sen = base / "sen12"
    season = JS.Seasons.SUMMER.value
    for scene in (3, 11):
        for sensor in ("s1", "s2", "s2_cloudy"):
            d = sen / season / f"{sensor}_{scene}"
            d.mkdir(parents=True)
            for pid in (0, 2, 5, 9, 13):
                (d / f"{season}_{sensor}_{scene}_p{pid}.tif").write_bytes(b"")
    out["sen12mscr"] = str(sen)
    return out


def sen12_reader(path, bands):
    """A stand-in GeoTIFF reader: seeded per file name, 13 bands."""
    rng = np.random.default_rng(zlib.crc32(os.path.basename(path).encode()))
    return rng.uniform(0, 12000, (16, 16, 13)).astype(np.float32)[:, :, [b - 1 for b in bands]]


DATASETS = {
    "synthetic": lambda M, t: M.SyntheticEO(size=12, length=6, with_cond_image=True,
                                            data_range=(-1.0, 1.0), texture=0.5),
    "synthetic_classes": lambda M, t: M.SyntheticEO(size=8, length=6, num_classes=3,
                                                    class_correlated=True, with_mask=False),
    "synthetic_hard": lambda M, t: M.SyntheticEOHard(size=16, length=10, with_cond_image=True),
    "mnist": lambda M, t: M.MNISTDataset(t["mnist"], train=True),
    "mnist_t10k_resized": lambda M, t: M.MNISTDataset(t["mnist"], train=False, image_size=14),
    "cifar10": lambda M, t: M.CIFAR10Dataset(t["cifar10"], train=True),
    "inria": lambda M, t: M.InriaDataset(t["inria"], size=32, patch_overlap=0.5, num_patches=5),
    "inria_length": lambda M, t: M.InriaDataset(t["inria"], size=32, num_patches=3, length=2),
    "clouds": lambda M, t: M.CloudMaskDataset(t["clouds"], size=64, num_patches=3, length=0),
    "clouds_classes": lambda M, t: M.CloudMaskDataset(
        t["clouds"], classes=("urban/developed",), percents=(50, 25), size=32,
        num_patches=2, ratio=0.5, length=3),
    "oscd": lambda M, t: M.OSCDDataset(os.path.join(t["oscd"], "OSCD_64_32", "train"),
                                       length=4, return_pair=True),
    "sarwake": lambda M, t: M.SARWakeDataset(t["sarwake"], mode="val", size=32,
                                             num_patches=7, length=3),
    "eurosat": lambda M, t: M.EuroSATDataset(t["eurosat"]),
    "sen12mscr": lambda M, t: (PS if M is PD else JS).SEN12MSCRCloudRemoval(
        t["sen12mscr"], reader=sen12_reader),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_items_match_jax(trees, name):
    assert_datasets_equal(DATASETS[name](PD, trees), DATASETS[name](JD, trees))


def test_cloud_mask_csv_filter_keeps_the_pandas_rows(trees):
    """The stdlib CSV reading keeps the rows pandas keeps: not sceneC
    (snow/ice), not sceneD (empty clear_percent), not sceneE (no class)."""
    ds = PD.CloudMaskDataset(trees["clouds"], size=64, num_patches=1, length=0)
    assert ds.names == JD.CloudMaskDataset(trees["clouds"], size=64, num_patches=1,
                                           length=0).names == ["sceneA", "sceneB"]


def test_sen12mscr_indexing_matches_jax(trees):
    p, j = PS.SEN12MSCR(trees["sen12mscr"], reader=sen12_reader), JS.SEN12MSCR(
        trees["sen12mscr"], reader=sen12_reader)
    season = PS.Seasons.SUMMER
    assert p.get_scene_ids(season) == j.get_scene_ids(JS.Seasons.SUMMER) == {3, 11}
    assert p.get_patch_ids(season, 11) == j.get_patch_ids("ROIs1868_summer", 11) == [0, 2, 5, 9, 13]
    for bands in ((PS.S2Bands.RGB, JS.S2Bands.RGB), ((PS.S2Bands.B08, 2), (JS.S2Bands.B08, 2))):
        assert_same(p.get_patch(season, PS.Sensor.s2cloudy, 3, 5, bands[0]),
                    j.get_patch(season.value, JS.Sensor.s2cloudy, 3, 5, bands[1]))
    for a, b in zip(p.get_s1_s2_s2cloudy_triplet(season, 3, 9),
                    j.get_s1_s2_s2cloudy_triplet(season.value, 3, 9)):
        assert_same(a, b)
    with pytest.raises(FileNotFoundError):
        PS.SEN12MSCR(os.path.join(trees["sen12mscr"], "missing"))
    with pytest.raises(NameError):
        p.get_scene_ids(PS.Seasons.WINTER)


def test_metadata_and_class_names_match_jax():
    for name in list(JD._METADATA) + ["inria", "unknown"]:
        for n in (0, 3, 12):
            assert PD.class_names(name, n) == JD.class_names(name, n)
        if name in JD._METADATA:
            assert PD.get_metadata(name) == JD.get_metadata(name)
    with pytest.raises(ValueError):
        PD.get_metadata("unknown")


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

LOADER_CASES = {
    "shuffle": dict(shuffle=True),
    "ordered_ragged": dict(shuffle=False, drop_last=False),
    "shard": dict(shard=(1, 3), drop_last=False),
    "flips": dict(transforms="_FLIPS"),
    "workers_augs": dict(num_workers=3, transforms="_oscd_augs"),
    "workers_no_prefetch": dict(num_workers=3, prefetch=0, drop_last=False, transforms="_FLIPS"),
    "no_prefetch": dict(prefetch=0, seed=7),
}


def loaders(case, n=37, batch=4):
    kw = dict(LOADER_CASES[case])
    out = []
    for D, L, F in ((PD, PL, PF), (JD, JL, JF)):
        k = dict(kw)
        if k.get("transforms") == "_FLIPS":
            k["transforms"] = F._FLIPS
        elif k.get("transforms") == "_oscd_augs":
            k["transforms"] = F._oscd_augs()
        ds = D.SyntheticEO(size=8, length=n, with_cond_image=True)
        out.append(L.DataLoader(ds, batch, **k))
    return out


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_match_jax_over_two_epochs(case):
    p, j = loaders(case)
    assert len(p) == len(j)
    for _ in range(2):
        bp, bj = list(p), list(j)
        assert len(bp) == len(bj) == len(j)
        for a, b in zip(bp, bj):
            assert_same(a, b)


def test_loader_resume_continues_the_order():
    p, j = loaders("flips")
    list(p), list(j)
    state = p.state()
    assert state == j.state()
    resumed = loaders("flips")[0]
    resumed.load_state(state)
    for a, b, c in zip(resumed, p, j):
        assert_same(a, b)
        assert_same(a, c)
    with pytest.raises(ValueError, match="seed"):
        resumed.load_state({"epoch": 1, "seed": 99})


def test_loader_error_reaches_the_consumer():
    class Broken(PD.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise KeyError(i)

    with pytest.raises(KeyError):
        list(PL.DataLoader(Broken(), 4))


def test_device_prefetch_on_the_cpu_yields_the_batches_as_tensors():
    p, _ = loaders("shuffle")
    want = list(loaders("shuffle")[0])
    got = list(PL.device_prefetch(iter(p), "cpu", size=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in g.values())
        assert_same({k: v.numpy() for k, v in g.items()}, w)


# ---------------------------------------------------------------------------
# the factories
# ---------------------------------------------------------------------------

FACTORY_KW = {
    "mnist": lambda t: dict(root=t["mnist"], num_workers=2),
    "cifar10": lambda t: dict(root=t["cifar10"]),
    "inria": lambda t: dict(root=t["inria"], image_size=32, num_patches=4),
    "clouds": lambda t: dict(root=t["clouds"], size=64, num_patches=4, length=0),
    "oscd": lambda t: dict(root=t["oscd"], length=4),
    "sarwake": lambda t: dict(root=t["sarwake"], size=32, num_patches=4, length=3),
    "eurosat": lambda t: dict(root=t["eurosat"], num_workers=3),
    "sen12mscr": lambda t: dict(root=t["sen12mscr"], reader=sen12_reader),
    "synthetic": lambda t: dict(image_size=8, length=40, with_cond_image=True),
    "synthetic_hard": lambda t: dict(image_size=16, length=30),
}


def test_every_jax_factory_is_ported():
    assert set(JF.DATASET_FACTORIES) <= set(PF.DATASET_FACTORIES)
    assert set(FACTORY_KW) == set(JF.DATASET_FACTORIES)


@pytest.mark.parametrize("name", sorted(FACTORY_KW))
def test_factory_batches_match_jax(trees, name):
    kw = FACTORY_KW[name](trees)
    (ptr, pte), (jtr, jte) = (PF.DATASET_FACTORIES[name](3, **kw),
                              JF.DATASET_FACTORIES[name](3, **kw))
    assert (len(ptr), len(pte)) == (len(jtr), len(jte))
    assert ptr.num_workers == jtr.num_workers and pte.drop_last == jte.drop_last
    # the synthetic fixture builds its items on the consuming thread
    want = (0, 0) if name.startswith("synthetic") else (jtr.prefetch, jte.prefetch)
    assert (ptr.prefetch, pte.prefetch) == want
    for a, b in zip(list(ptr)[:2], list(jtr)[:2]):
        assert_same(a, b)
    assert_same(next(iter(pte)), next(iter(jte)))
    if name not in ("synthetic", "synthetic_hard"):  # return_dataset / test=
        pds, jds = (PF.DATASET_FACTORIES[name](3, return_dataset=True, **kw),
                    JF.DATASET_FACTORIES[name](3, return_dataset=True, **kw))
        assert [len(d) for d in pds] == [len(d) for d in jds]
        if name not in ("mnist", "cifar10"):
            ptr, jtr = (PF.DATASET_FACTORIES[name](3, test=True, **kw)[0],
                        JF.DATASET_FACTORIES[name](3, test=True, **kw)[0])
            assert ptr.transforms is None and jtr.transforms is None
            assert_same(next(iter(ptr)), next(iter(jtr)))


# ---------------------------------------------------------------------------
# the device cache and the patch exporter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,flips", [("float32", True), ("bfloat16", True),
                                         ("float32", False)])
def test_gather_core_given_jax_draws_matches_gather_batch(dtype, flips):
    rng = np.random.default_rng(0)
    data = {"image": rng.normal(size=(7, 6, 5, 3)).astype(np.float32),
            "mask": (rng.uniform(size=(7, 6, 5)) > 0.5).astype(np.float32),
            "label": np.arange(7, dtype=np.int32)}
    key, batch = jax.random.PRNGKey(3), 9
    want = JC.gather_batch({k: jnp.asarray(v) for k, v in data.items()}, key, batch,
                           getattr(jnp, dtype), flips)
    # gather_batch's own draws, un-jitted
    idx_rng, fh, fv = jax.random.split(key, 3)
    idx = np.array(jax.random.randint(idx_rng, (batch,), 0, 7))
    do_h = np.array(jax.random.bernoulli(fh, shape=(batch,)))
    do_v = np.array(jax.random.bernoulli(fv, shape=(batch,)))
    assert do_h.any() and do_v.any() and not do_h.all()
    got = PC.gather_core({k: torch.from_numpy(v) for k, v in data.items()},
                         torch.from_numpy(idx).long(), torch.from_numpy(do_h),
                         torch.from_numpy(do_v), getattr(torch, dtype), flips)
    for k in data:
        w = np.asarray(want[k].astype(jnp.float32) if dtype == "bfloat16" and k != "label"
                       else want[k])
        g = got[k].float() if got[k].dtype == torch.bfloat16 else got[k]
        assert got[k].dtype == (getattr(torch, dtype) if k != "label" else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w)


def test_device_cache_on_the_cpu_draws_from_its_generator():
    rng = np.random.default_rng(1)
    data = {"image": rng.normal(size=(5, 4, 4, 3)).astype(np.float32),
            "cond": rng.normal(size=(5, 4, 4, 3)).astype(np.float32)}
    cache = PC.DeviceDataCache(data, "cpu")
    assert cache.n == 5 and cache.nbytes() == 2 * 5 * 48 * 4
    out = cache.sample_batch(torch.Generator().manual_seed(4), 6)
    g = torch.Generator().manual_seed(4)
    idx = torch.randint(0, 5, (6,), generator=g)
    do_h, do_v = torch.rand(6, generator=g) < 0.5, torch.rand(6, generator=g) < 0.5
    for k, v in data.items():
        want = v[idx.numpy()].copy()
        for i in range(6):
            if do_h[i]:
                want[i] = want[i][:, ::-1]
            if do_v[i]:
                want[i] = want[i][::-1]
        np.testing.assert_array_equal(out[k].numpy(), want)
    with pytest.raises(ValueError, match="leading"):
        PC.DeviceDataCache({"a": np.zeros((2, 1)), "b": np.zeros((3, 1))}, "cpu")


def test_export_patches_writes_what_jax_writes(tmp_path):
    from eo_diffusion_torch.tools import export_patches as PE
    from eo_diffusion_tpu.tools import export_patches as JE

    for M, D in ((PE, PD), (JE, JD)):
        assert M.export(D.SyntheticEO(size=8, length=5), str(tmp_path / M.__name__),
                        limit=3) == 3
    p, j = tmp_path / PE.__name__, tmp_path / JE.__name__
    assert sorted(os.listdir(p)) == sorted(os.listdir(j))
    for name in os.listdir(j):
        assert (p / name).read_bytes() == (j / name).read_bytes(), name
