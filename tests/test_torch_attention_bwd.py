"""The port's attention backward (reference_attention_bwd and the QKVAttention
autograd.Function) against the JAX package's flash backward, with the Pallas
kernel K4 run in interpret mode as tests/test_ops.py runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.ops import attention as TA
from eo_diffusion_tpu.ops import attention as JA
from torch_parity import one_torch_thread, rel_err  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(JA, "_INTERPRET", True)
    yield


def _inputs(b, t, c3, seed, c=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, c3)).astype(np.float32),
            rng.normal(size=(b, t, c or c3 // 3)).astype(np.float32))


@pytest.mark.parametrize("new_order", [False, True])
@pytest.mark.parametrize("d", [48, 64])
def test_function_gradient_matches_pallas_backward(new_order, d):
    """d(sum(attention * g))/d qkv: QKVAttention on the CPU (saved qkv/out/lse,
    plain backward, restack in the head order) against jax.grad through the
    Pallas forward and backward kernels. float32, rel-err <= 1e-5."""
    heads, t = 2, 128
    qkv, g = _inputs(2, t, 3 * heads * d, seed=d + new_order)
    ref = jax.grad(lambda x: jnp.sum(JA.attention_from_qkv(
        x, heads, new_order=new_order, impl="pallas", block_q=64, block_k=64, min_seq=0)
        * g))(jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    (got,) = torch.autograd.grad(TA.attention_from_qkv(x, heads, new_order), x,
                                 torch.from_numpy(g))
    assert rel_err(got, ref) <= 1e-5


def test_plain_backward_matches_pallas_backward_ragged_t():
    """reference_attention_bwd on [B, T, H, D] against flash_attention's
    backward at T 56 (padded q rows, a masked KV tail), D 48."""
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.normal(size=(2, 56, 4, 48)).astype(np.float32) for _ in range(4))
    ref = jax.grad(lambda q, k, v: jnp.sum(JA.flash_attention(q, k, v, 32, 32) * g),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = TA.reference_attention(tq, tk, tv, return_lse=True)
    got = TA.reference_attention_bwd(tq, tk, tv, o, lse, tg)
    for a, b in zip(got, ref):
        assert rel_err(a, b) <= 1e-5


@pytest.mark.parametrize("new_order", [False, True])
def test_function_gradient_equals_plain_autograd(new_order):
    qkv, g = _inputs(2, 40, 3 * 4 * 16, seed=5)
    g = torch.from_numpy(g)
    x = torch.from_numpy(qkv).requires_grad_()
    (got,) = torch.autograd.grad(TA.attention_from_qkv(x, 4, new_order), x, g)
    (want,) = torch.autograd.grad(TA.attention_from_qkv(x, 4, new_order, impl="plain"), x, g)
    assert rel_err(got, want.numpy()) <= 1e-5
    # stack_qkv undoes split_qkv in either order
    assert torch.equal(TA.stack_qkv(*TA.split_qkv(x, 4, new_order), new_order=new_order), x)


def test_no_gradient_needed_saves_nothing():
    """Without autograd the Function computes no lse and saves no tensor, so
    the sampling path stays what it was."""
    qkv = torch.from_numpy(_inputs(1, 16, 96, seed=6)[0])
    with torch.inference_mode():
        out = TA.attention_from_qkv(qkv, 2)
    assert not out.requires_grad and out.grad_fn is None
    want = TA.reference_attention(*TA.split_qkv(qkv, 2)).reshape(1, 16, 32)
    assert torch.equal(out, want)
    out = TA.attention_from_qkv(qkv.clone().requires_grad_(), 2)
    assert out.grad_fn is not None and len(out.grad_fn.saved_tensors) == 3


def test_bf16_rounds_where_the_recipe_says():
    """bf16 inputs: q*s, k*s, p and ds round to bf16, everything else is f32.
    Written out here independently of reference_attention_bwd."""
    rng = np.random.default_rng(7)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(1, 24, 2, 16)).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(4))
    o, lse = TA.reference_attention(q, k, v, return_lse=True)
    got = TA.reference_attention_bwd(q, k, v, o, lse, g)
    assert all(x.dtype == torch.bfloat16 for x in got)

    sc = 16 ** -0.25
    s = torch.tensor(sc, dtype=torch.bfloat16)
    qs, ks = (q * s).float(), (k * s).float()
    assert (q * s).dtype == torch.bfloat16
    w = torch.einsum("bthd,bshd->bhts", qs, ks)
    p = torch.exp(w - lse.reshape(1, 2, 24, 1))
    delta = (g.float() * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (torch.einsum("bthd,bshd->bhts", g.float(), v.float()) - delta)
    p_b, ds_b = p.bfloat16().float(), ds.bfloat16().float()
    want = ((torch.einsum("bhts,bshd->bthd", ds_b, ks) * sc).bfloat16(),
            (torch.einsum("bhts,bthd->bshd", ds_b, qs) * sc).bfloat16(),
            torch.einsum("bhts,bthd->bshd", p_b, g.float()).bfloat16())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and without the roundings of p and ds the result differs: they matter
    dv_unrounded = torch.einsum("bhts,bthd->bshd", p, g.float()).bfloat16()
    assert not torch.equal(dv_unrounded, got[2])


def test_cuda_wrappers_refuse_cpu_tensors():
    qkv = torch.zeros(1, 8, 96)
    with pytest.raises(ValueError, match="CUDA"):
        TA.qkv_attention_bwd_cuda(qkv, torch.zeros(1, 8, 32), torch.zeros(2, 8),
                                  torch.zeros(1, 8, 32), 2)
    assert TA.qkv_attention_bwd_cuda.launches == 0
