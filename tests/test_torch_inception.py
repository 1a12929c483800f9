"""The port's InceptionV3 (eo_diffusion_torch.models.inception) against the
JAX package's on the CPU, on seeded random weights (none are bundled, so no
standard FID is claimed): a seeded state dict under torchvision's names goes
through JAX's ``convert_torch_state_dict`` on one side and straight into
``load_state_dict`` on the other. InceptionV3 at 75 px, batch 2: pool3 and
logits within 1e-5 relative. One jitted JAX function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import inception as T
from eo_diffusion_tpu.models import inception as J
from torch_parity import one_torch_thread  # noqa: F401

REL_TOL = 1e-5
SIZE = 75  # the smallest input the architecture takes


def seeded_torchvision_state_dict(seed):
    """Every entry of a torchvision ``inception_v3`` state dict (AuxLogits
    and ``num_batches_tracked`` included) with seeded values: He-scaled
    kernels, BatchNorm near identity with positive variances."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in T.InceptionV3().state_dict().items():
        s = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros((), np.int64)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, s).astype(np.float32)
        elif k.endswith("running_mean"):
            sd[k] = (0.1 * rng.normal(size=s)).astype(np.float32)
        elif k.endswith("bn.weight"):
            sd[k] = (1 + 0.05 * rng.normal(size=s)).astype(np.float32)
        elif len(s) > 1:
            sd[k] = (rng.normal(size=s) * np.sqrt(2 / np.prod(s[1:]))).astype(np.float32)
        else:
            sd[k] = (0.05 * rng.normal(size=s)).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def twin():
    sd = seeded_torchvision_state_dict(0)
    jparams = J.convert_torch_state_dict(sd)
    x = np.random.default_rng(1).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    run = jax.jit(lambda p, x: J.InceptionV3().apply(p, J.preprocess(x, SIZE)))
    ref = {k: np.asarray(v) for k, v in run(jparams, jnp.asarray(x)).items()}
    return sd, jax.tree.map(np.asarray, jparams), x, ref


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_torchvision_state_dict_loads_as_is_and_matches_jax(twin):
    sd, _, x, ref = twin
    model = T.InceptionV3()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = model.eval()(T.preprocess(x, SIZE))
    for k in ("pool3", "logits"):
        assert out[k].shape == ref[k].shape == (2, {"pool3": 2048, "logits": 1000}[k])
        assert np.abs(ref[k]).max() > 0.1 and _rel(out[k].numpy(), ref[k]) <= REL_TOL, k


def test_flax_tree_to_state_dict_inverts_the_jax_converter(twin):
    sd, jparams, x, ref = twin
    back = T.state_dict_from_flax(jparams)
    want = {k: v for k, v in sd.items() if not k.startswith("AuxLogits")}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    model = T.InceptionV3(aux_logits=False)
    model.load_state_dict(back, strict=True)
    with torch.no_grad():
        assert _rel(model.eval()(T.preprocess(x, SIZE))["logits"].numpy(),
                    ref["logits"]) <= REL_TOL


def test_load_torch_inception_and_the_extractor(twin, tmp_path):
    """The .pth loads as it is; the extractor runs the model on the 299 px
    preprocessed batch in chunks and gives pool3 and softmax(logits)."""
    sd, _, x, _ = twin
    path = str(tmp_path / "inception_v3_google.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    model = T.load_torch_inception(path)
    assert not model.training and hasattr(model, "AuxLogits")
    feats, probs = T.inception_feature_extractor(model, batch_size=1, with_logits=True)(x)
    with torch.no_grad():
        out = model(T.preprocess(x))
    assert feats.shape == (2, 2048) and _rel(feats, out["pool3"].numpy()) <= REL_TOL
    np.testing.assert_allclose(probs, torch.softmax(out["logits"], -1).numpy(), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


def test_preprocess_matches_jax():
    """Grey to RGB, JAX's bilinear resize (up and down), (x - 0.5) / 0.5."""
    rng = np.random.default_rng(2)
    for shape, size in (((2, 12, 12, 1), 20), ((1, 30, 30, 3), 16), ((1, 9, 9, 3), 9)):
        x = rng.uniform(size=shape).astype(np.float32)
        want = np.asarray(J.preprocess(jnp.asarray(x), size))
        got = T.preprocess(x, size).numpy()
        assert got.shape == want.shape == (shape[0], size, size, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
