"""The port's attention (eo_diffusion_torch.ops.attention) against the JAX
package: its fused-qkv Pallas kernel K1 run in interpret mode, and its XLA
reference for a ragged T. On the CPU the port runs its plain version; the
CUDA kernel itself is checked on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.ops import attention as TA
from eo_diffusion_tpu.ops import attention as JA
from torch_parity import one_torch_thread  # noqa: F401

# f32: max |port - jax| / max |jax| (both accumulate in f32, in other orders)
REL_TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(JA, "_INTERPRET", True)
    yield


def _qkv(b, t, heads, d, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, t, 3 * heads * d)).astype(np.float32)


def _rel(out, ref):
    return float(np.abs(np.asarray(out) - np.asarray(ref)).max() / np.abs(ref).max())


def _qkv5(qkv, heads, new_order):
    """[B, T, 3C] -> the Pallas kernel's [B, 3, H, T, D] layout."""
    b, t, c3 = qkv.shape
    d = c3 // 3 // heads
    if new_order:
        return qkv.reshape(b, t, 3, heads, d).transpose(0, 2, 3, 1, 4)
    return qkv.reshape(b, t, heads, 3, d).transpose(0, 3, 2, 1, 4)


K1_CASES = [(d, new_order) for d in (48, 128) for new_order in (False, True)]


@pytest.fixture(scope="module")
def pallas_k1():
    """K1's outputs (interpreted) for every case of the two tests below, from
    one jitted function (one compile): the fused-qkv entry at D 48 and 128
    in both head orders, and the lse of ``_qkv5_fwd_impl`` in both."""
    old, JA._INTERPRET = JA._INTERPRET, True
    try:
        @jax.jit
        def run(k1_in, lse_in):
            k1 = [JA.attention_from_qkv(x, 2, new_order=o, impl="pallas", block_q=32,
                                        block_k=32) for x, (_, o) in zip(k1_in, K1_CASES)]
            return k1, [JA._qkv5_fwd_impl(x, 32, 32, return_lse=True) for x in lse_in]

        qkv = _qkv(2, 64, 2, 48, seed=7)
        k1, lse = run([jnp.asarray(_qkv(1, 64, 2, d, seed=d + o)) for d, o in K1_CASES],
                      [jnp.asarray(_qkv5(qkv, 2, o)) for o in (False, True)])
        return ({case: np.asarray(r) for case, r in zip(K1_CASES, k1)},
                {o: jax.tree.map(np.asarray, r) for o, r in zip((False, True), lse)})
    finally:
        JA._INTERPRET = old


# D 48 takes the transposed-PV body (_qkv_layout_kernel_tpv), D 128 the plain one
@pytest.mark.parametrize("d", [48, 128])
@pytest.mark.parametrize("new_order", [False, True])
def test_matches_pallas_k1(pallas_k1, d, new_order):
    qkv = _qkv(1, 64, 2, d, seed=d + new_order)
    ref = pallas_k1[0][(d, new_order)]
    out = TA.attention_from_qkv(torch.from_numpy(qkv), 2, new_order=new_order)
    assert out.shape == (1, 64, 2 * d)
    assert _rel(out.numpy(), ref) <= REL_TOL


@pytest.mark.parametrize("new_order", [False, True])
def test_lse_matches_pallas_k1(pallas_k1, new_order):
    qkv = _qkv(2, 64, 2, 48, seed=7)
    o_ref, lse_ref = pallas_k1[1][new_order]
    out, lse = TA.attention_from_qkv(torch.from_numpy(qkv), 2, new_order=new_order,
                                     return_lse=True)
    assert lse.shape == (2 * 2, 64) and lse.dtype == torch.float32
    lse_ref = np.asarray(lse_ref)[..., 0].reshape(4, 64)
    assert _rel(lse.numpy(), lse_ref) <= REL_TOL
    o_ref = np.asarray(o_ref).transpose(0, 2, 1, 3).reshape(2, 64, 96)
    assert _rel(out.numpy(), o_ref) <= REL_TOL


@pytest.mark.parametrize("new_order", [False, True])
def test_ragged_t_matches_xla(new_order):
    qkv = _qkv(2, 40, 4, 16, seed=3)
    ref = JA.attention_from_qkv(jnp.asarray(qkv), 4, new_order=new_order, impl="xla")
    out = TA.attention_from_qkv(torch.from_numpy(qkv), 4, new_order=new_order)
    assert _rel(out.numpy(), ref) <= REL_TOL


def test_cpu_never_launches_the_kernel():
    before = TA.qkv_attention_cuda.launches
    qkv = torch.from_numpy(_qkv(1, 16, 2, 8, seed=0))
    TA.attention_from_qkv(qkv, 2)
    TA.attention_from_qkv(qkv, 2, impl="plain")
    assert TA.qkv_attention_cuda.launches == before == 0
    with pytest.raises(ValueError):
        TA.qkv_attention_cuda(qkv, 2)  # the kernel wrapper takes CUDA tensors only
    with pytest.raises(ValueError):
        TA.attention_from_qkv(qkv, 2, impl="pallas")


def test_bf16_inputs_scale_in_their_dtype():
    """q*s and k*s round in the input dtype before the f32 products."""
    qkv = torch.from_numpy(_qkv(1, 16, 2, 8, seed=5)).to(torch.bfloat16)
    q, k, v = TA.split_qkv(qkv, 2)
    s = torch.tensor(TA._scale(8), dtype=torch.bfloat16)
    w = torch.einsum("bthd,bshd->bhts", (q * s).float(), (k * s).float()).softmax(-1)
    ref = torch.einsum("bhts,bshd->bthd", w, v.float()).to(torch.bfloat16)
    out = TA.attention_from_qkv(qkv, 2)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.reshape(1, 16, 16))
