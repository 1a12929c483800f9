"""The arithmetic of the float32 attention kernels (``ops/csrc/
attention_f32_sm90.cu``) emulated in plain torch on the CPU: every product
the sum of three TF32 products (x = hi + lo, hi = x rounded to TF32, lo the
rest, which the tensor core reads truncated to TF32), f32 sums. At the
``synthetic64`` classifier's B8 T256 H4 D48 the three-term split stays within
``TOL_ATTN_L2[float32]`` (1e-5, the card checks' limit) of the port's plain
float32 attention, itself held against the JAX package in
``tests/test_torch_attention.py``, and one TF32 product does not: so the card
checks can tell the split from plain TF32. No JAX here.
"""

import numpy as np
import pytest
import torch

from eo_diffusion_torch.ops import attention as A

TOL_ATTN_L2 = 1e-5  # chip_smoke.py's TOL_ATTN_L2[float32]
B, T, H, D = 8, 256, 4, 48


def tf32(x: torch.Tensor, nearest: bool) -> torch.Tensor:
    """x with its mantissa cut to TF32's 10 bits: rounded to nearest, ties
    away from zero (``cvt.rna.tf32.f32``), or truncated (what the tensor core
    does with the low bits of an operand)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000  # half of the 13 dropped bits, on the magnitude
    return (bits & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b as the kernel forms it: hi*hi (+ hi*lo + lo*hi for three terms),
    each product of two TF32 values exact in f32 and summed in f32."""
    ah, bh = tf32(a, True), tf32(b, True)
    out = ah @ bh
    if terms == 3:
        al, bl = tf32(a - ah, False), tf32(b - bh, False)
        out = (al @ bh + ah @ bl) + out
    return out


def attention(q, k, v, terms):
    """The kernel's forward, [B, T, H, D] -> (o, lse): q and k scaled by
    D^-1/4, scores, exp in base 2 from the row max, p split like every other
    operand, o normalised once."""
    s = A._scale(q.shape[-1])
    qs, ks, vs = (x.permute(0, 2, 1, 3) for x in (q * s, k * s, v))
    w = matmul(qs, ks.transpose(-1, -2), terms)
    m = w.amax(-1, keepdim=True)
    p = torch.exp2(w * 1.4426950408889634 - m * 1.4426950408889634)
    l = p.sum(-1, keepdim=True)
    o = matmul(p, vs, terms) / l
    return o.permute(0, 2, 1, 3), (m + l.log()).reshape(-1, q.shape[1])


def attention_bwd(q, k, v, o, lse, do, terms):
    """The kernel's backward from the saved lse: p = exp(S - lse), dS =
    p (dP - delta), the five products split; (dq, dk, dv)."""
    s = A._scale(q.shape[-1])
    qs, ks, vs, os_, dos = (x.permute(0, 2, 1, 3) for x in (q * s, k * s, v, o, do))
    w = matmul(qs, ks.transpose(-1, -2), terms)
    p = torch.exp2(w * 1.4426950408889634 - lse.reshape(w.shape[:3] + (1,)) * 1.4426950408889634)
    dp = matmul(dos, vs.transpose(-1, -2), terms)
    ds = p * (dp - (dos * os_).sum(-1, keepdim=True))
    dv = matmul(p.transpose(-1, -2), dos, terms)
    dq = matmul(ds, ks, terms) * s
    dk = matmul(ds.transpose(-1, -2), qs, terms) * s
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def rel_l2(got, want):
    got = torch.cat([g.reshape(-1) for g in got]).double()
    want = torch.cat([w.reshape(-1) for w in want]).double()
    return ((got - want).norm() / want.norm()).item()


@pytest.fixture(scope="module")
def draws():
    """Unit-normal q, k, v and dO (the card checks' inputs), from numpy."""
    rng = np.random.default_rng(19)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(np.float32))
                   for _ in range(4))
    o, lse = A.reference_attention(q, k, v, return_lse=True)
    return q, k, v, do, o, lse


def test_tf32_rounding_is_tf32():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -10 + 2.0 ** -11),
                      3.0e-30], dtype=torch.float32)
    hi = tf32(x, True)
    assert hi.tolist()[:3] == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -9)]
    assert torch.equal(hi + (x - hi), x)  # the split is exact
    assert (tf32(x, False).view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("terms", [3, 1])
def test_forward_split_within_the_f32_limit(draws, terms):
    q, k, v, _, ref, ref_lse = draws
    o, lse = attention(q, k, v, terms)
    err = rel_l2([o], [ref])
    if terms == 3:
        assert err <= TOL_ATTN_L2 / 10, err
        assert (lse - ref_lse).abs().max().item() <= 1e-5
    else:  # plain TF32 parts from float32 by about 2^-11 a product
        assert err > 10 * TOL_ATTN_L2, err


@pytest.mark.parametrize("terms", [3, 1])
def test_backward_split_within_the_f32_limit(draws, terms):
    q, k, v, do, o, lse = draws
    want = A.reference_attention_bwd(q, k, v, o, lse, do)
    err = rel_l2(attention_bwd(q, k, v, o, lse, do, terms), want)
    if terms == 3:
        assert err <= TOL_ATTN_L2 / 10, err
    else:
        assert err > 10 * TOL_ATTN_L2, err
