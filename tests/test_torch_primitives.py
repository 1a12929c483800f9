"""The port's NN primitives against eo_diffusion_tpu/nn/primitives.py (f32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.nn import primitives as TP
from eo_diffusion_tpu.nn import primitives as JP
from torch_parity import one_torch_thread  # noqa: F401

# f32: max |port - jax| / max |jax|
REL_TOL = 1e-5


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dim", [32, 33])  # even, and odd (zero-padded last column)
def test_timestep_embedding(dim):
    t = np.array([0, 1, 7, 500, 999], np.int32)
    ref = JP.timestep_embedding(jnp.asarray(t), dim)
    out = TP.timestep_embedding(torch.from_numpy(t), dim)
    assert out.dtype == torch.float32 and out.shape == (5, dim)
    assert _rel(out.numpy(), ref) <= REL_TOL
    if dim % 2:
        assert np.all(out.numpy()[:, -1] == 0)


# 64 channels -> 32 groups; 24 is not a multiple of 32 -> 24 groups of 1
@pytest.mark.parametrize("ch", [64, 24])
def test_group_norm32(ch):
    rng = np.random.default_rng(ch)
    x = (3.0 + 2.0 * rng.normal(size=(2, 5, 6, ch))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=ch)).astype(np.float32)
    bias = (0.1 * rng.normal(size=ch)).astype(np.float32)
    gn = JP.GroupNorm32()
    params = {"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}
    ref = gn.apply(params, jnp.asarray(x))
    mod = TP.GroupNorm32(ch)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        out = mod(torch.from_numpy(x))
    assert mod.groups == (32 if ch == 64 else 24)
    assert _rel(out.numpy(), ref) <= REL_TOL
    # bf16 activations keep f32 statistics and come back as bf16
    with torch.no_grad():
        outb = mod(torch.from_numpy(x).to(torch.bfloat16))
    assert outb.dtype == torch.bfloat16


@pytest.mark.parametrize("stride,size", [(2, 9), (2, 8), (1, 7)])
def test_conv_torch_padding(stride, size):
    """Explicit (k-1)//2 padding places strided windows like torch Conv2d."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, 5, 4)).astype(np.float32)  # HWIO
    bias = rng.normal(size=4).astype(np.float32)
    ref = JP.Conv(4, 3, stride=stride).apply({"params": {"kernel": kernel, "bias": bias}},
                                             jnp.asarray(x))
    conv = TP.Conv(5, 4, 3, stride=stride)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(bias))
        out = conv(torch.from_numpy(x))
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) <= REL_TOL


@pytest.mark.parametrize("size", [3, 4])  # 3x3 takes the reference's 6x6 -> 7x7 pad
def test_nearest_upsample(size):
    x = np.random.default_rng(0).normal(size=(2, size, size, 3)).astype(np.float32)
    ref = np.asarray(JP.nearest_upsample_2d(jnp.asarray(x)))
    out = TP.nearest_upsample_2d(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == ((2, 7, 7, 3) if size == 3 else (2, 8, 8, 3))
    np.testing.assert_array_equal(out, ref)


def test_avg_pool_and_dense():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 6, 4)).astype(np.float32)
    np.testing.assert_allclose(TP.avg_pool_2d(torch.from_numpy(x)).numpy(),
                               np.asarray(JP.avg_pool_2d(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    kernel = rng.normal(size=(4, 7)).astype(np.float32)
    bias = rng.normal(size=7).astype(np.float32)
    ref = jax.jit(JP.Dense(7).apply)({"params": {"kernel": kernel, "bias": bias}},
                                     jnp.asarray(x))
    dense = TP.Dense(4, 7)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(kernel.T))
        dense.bias.copy_(torch.from_numpy(bias))
        out = dense(torch.from_numpy(x))
    assert _rel(out.numpy(), ref) <= REL_TOL
