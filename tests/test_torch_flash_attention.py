"""The port's flash_attention (eo_diffusion_torch.ops.attention) against the
JAX package's, run in interpret mode: the resident branch K2 (with its lse
and the Pallas backward K4) and the grid-tiled branch K3 (with the XLA
recompute as its backward), reached on tiny shapes by lowering
``_MAX_RESIDENT_KV``. On the CPU the port runs its plain versions through the
same ``FlashAttention`` plumbing the card uses; the CUDA kernels are held
against those plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

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
# bf16 forward: both round o to bf16 and q*s, k*s in bf16; the Pallas kernel
# also rounds p to bf16 before PV (2^-9 relative), the plain version does
# not: within an output ulp (2^-8) and a bit of max |o|
BF16_TOL = 1e-2


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(JA, "_INTERPRET", True)
    yield


@pytest.fixture(params=["resident", "grid"])
def regime(request, monkeypatch):
    """K2 (T <= _MAX_RESIDENT_KV) or K3 (the cap lowered below T)."""
    if request.param == "grid":
        monkeypatch.setattr(JA, "_MAX_RESIDENT_KV", 16)
    return request.param


def _bthd(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [(1.5 * rng.normal(size=(b, t, h, d))).astype(np.float32) for _ in range(3)]


def _rel(out, ref):
    out = out.detach().float().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref, dtype=np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# (T, block_q, block_k): aligned, and ragged (padded to the blocks in JAX)
SHAPES = [(64, 32, 32), (40, 16, 16)]
HEAD_DIMS = [160, 256]


def _vjp_inputs(t, d, seed):
    q, k, v = _bthd(1, t, 2, d, seed=seed)
    return q, k, v, np.random.default_rng(seed).normal(size=q.shape).astype(np.float32)


def _vjp_cases():
    """(regime, T, block_q, block_k, D, seed) of the two tests below."""
    return ([(r, t, bq, bk, 16, t) for r in ("resident", "grid") for t, bq, bk in SHAPES]
            + [(r, 40, 16, 16, d, d) for r in ("resident", "grid") for d in HEAD_DIMS])


@pytest.fixture(scope="module")
def pallas_vjps():
    """The JAX flash_attention's output and its vjp (K2 or K3 forward, K4 or
    the XLA recompute backward, interpreted) for every case of the two tests
    below, from one jitted function (one compile); K3's regime by the cap
    lowered below T while its cases are traced."""
    cases = _vjp_cases()
    old = JA._INTERPRET, JA._MAX_RESIDENT_KV
    JA._INTERPRET = True
    try:
        @jax.jit
        def run(args):
            outs = []
            for (regime, _, bq, bk, _, _), (q, k, v, g) in zip(cases, args):
                JA._MAX_RESIDENT_KV = 16 if regime == "grid" else old[1]
                ref, vjp = jax.vjp(lambda a, b, c, bq=bq, bk=bk: JA.flash_attention(
                    a, b, c, bq, bk), q, k, v)
                outs.append((ref, vjp(g)))
            return outs

        args = [tuple(map(jnp.asarray, _vjp_inputs(t, d, seed)))
                for _, t, _, _, d, seed in cases]
        return {case[:5]: jax.tree.map(np.asarray, out) for case, out in zip(cases, run(args))}
    finally:
        JA._INTERPRET, JA._MAX_RESIDENT_KV = old


@pytest.mark.parametrize("t,bq,bk", SHAPES)
def test_forward_and_gradients_match_pallas(pallas_vjps, regime, t, bq, bk):
    """Forward: K2 (with its lse, as training runs it) or K3. Gradients:
    in K2's regime the Pallas flash backward K4 in interpret mode, in K3's
    the XLA recompute. The port runs FlashAttention either way."""
    q, k, v, g = _vjp_inputs(t, 16, t)
    ref, ref_grads = pallas_vjps[(regime, t, bq, bk, 16)]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TA.flash_attention(qt, kt, vt)
    assert out.shape == (1, t, 2, 16) and out.dtype == torch.float32
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert _rel(out, ref) <= REL_TOL
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    for name, a, b in zip("qkv", grads, ref_grads):
        assert _rel(a, b) <= REL_TOL, name


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_head_dims_above_128_match_pallas(pallas_vjps, regime, d):
    """D 160 and 256, which the wgmma/TMA body takes on the card: the JAX
    forward pads D to a multiple of 128 (K2 or K3), its gradients are K4 or
    the XLA recompute; the port runs FlashAttention's plain versions."""
    q, k, v, g = _vjp_inputs(40, d, d)
    ref, ref_grads = pallas_vjps[(regime, 40, 16, 16, d)]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TA.flash_attention(qt, kt, vt)
    assert out.shape == (1, 40, 2, d) and _rel(out, ref) <= REL_TOL
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    for name, a, b in zip("qkv", grads, ref_grads):
        assert _rel(a, b) <= REL_TOL, name


# (dtype, d, fused, strides, ptrs): the kernel fwd_route picks, or None for a refusal
ROUTES = [
    (torch.bfloat16, 48, False, (), (), "sm90"),
    (torch.bfloat16, 256, False, (), (), "sm90"),    # D <= 256 on the separate entry
    (torch.bfloat16, 160, False, (), (), "sm90"),
    (torch.bfloat16, 264, False, (), (), None),      # above wgmma's N
    (torch.bfloat16, 128, True, (), (), "sm90"),     # D <= 128 on the fused entry
    (torch.bfloat16, 136, True, (), (), None),       # the JAX package's gate
    (torch.float32, 64, False, (), (), "fma"),       # float32: the FMA kernel
    (torch.float32, 128, True, (), (), "fma"),
    (torch.float32, 136, False, (), (), None),
    (torch.float16, 64, False, (), (), None),
    (torch.bfloat16, 44, False, (), (), None),       # not a multiple of 8
    (torch.bfloat16, 64, False, (3 * 64 * 8, 3 * 64, 64), (0,), "sm90"),
    (torch.bfloat16, 64, False, (1004, 3 * 64, 64), (0,), None),   # strides: 16-byte rows
    (torch.bfloat16, 64, True, (6148, 196), (0,), None),
    (torch.bfloat16, 64, False, (4096, 512, 64), (8,), None),      # base not on 16 bytes
    (torch.float32, 64, False, (4096, 512, 68), (0,), None),
]


@pytest.mark.parametrize("dtype,d,fused,strides,ptrs,kernel", ROUTES)
def test_fwd_route(dtype, d, fused, strides, ptrs, kernel):
    if kernel is None:
        with pytest.raises(ValueError):
            TA.fwd_route(dtype, d, strides, ptrs, fused=fused)
    else:
        assert TA.fwd_route(dtype, d, strides, ptrs, fused=fused) == kernel


# (dtype, d, fused, strides, ptrs): the kernel bwd_route picks, or None for a
# refusal: bf16 the wgmma/TMA body up to 256 (128 on the fused entry), float32
# the FMA kernel up to 128, q/k/v rows of 16 bytes
BWD_ROUTES = [
    *[(torch.bfloat16, d, fused, (), (), "sm90" if d <= (128 if fused else 256) else None)
      for d in (48, 64, 128, 136, 256, 264) for fused in (False, True)],
    *[(torch.float32, d, fused, (), (), "fma" if d <= 128 else None)
      for d in (48, 64, 128, 136, 256, 264) for fused in (False, True)],
    (torch.float16, 64, False, (), (), None),
    (torch.bfloat16, 40, False, (), (), "sm90"),     # padded to 64 inside
    (torch.bfloat16, 44, True, (), (), None),        # not a multiple of 8
    (torch.bfloat16, 48, True, (3 * 3 * 48 * 16, 3 * 3 * 48), (64,), "sm90"),  # fused qkv
    (torch.bfloat16, 48, True, (3 * 3 * 48 * 16, 3 * 3 * 48 + 4), (0,), None),
    (torch.bfloat16, 160, False, (4096, 512, 160, 4096, 512, 160, 4096, 512, 160),
     (0, 32, 1024), "sm90"),
    (torch.bfloat16, 160, False, (4096, 516, 160), (0,), None),       # token stride
    (torch.bfloat16, 64, False, (4096, 512, 64), (0, 8, 0), None),    # k's base
    (torch.float32, 64, False, (4096, 512, 64), (0, 0, 24), None),    # v's base
    (torch.float32, 64, True, (3 * 64 * 8, 3 * 64), (16,), "fma"),
]


@pytest.mark.parametrize("dtype,d,fused,strides,ptrs,kernel", BWD_ROUTES)
def test_bwd_route(dtype, d, fused, strides, ptrs, kernel):
    if kernel is None:
        with pytest.raises(ValueError) as err:
            TA.bwd_route(dtype, d, strides, ptrs, fused=fused)
        if not fused and d > {torch.bfloat16: 256, torch.float32: 128}.get(dtype, d):
            assert "ROADMAP queue 2, item 1" in str(err.value)
    else:
        assert TA.bwd_route(dtype, d, strides, ptrs, fused=fused) == kernel


@pytest.mark.parametrize("t,d,dtype,kernel", [
    (64, 1024, torch.bfloat16, "wide"),   # inria64's middle attention
    (64, 512, torch.bfloat16, "wide"),    # eurosat64's
    (1024, 264, torch.bfloat16, "wide"), (1040, 264, torch.bfloat16, None),
    (64, 256, torch.bfloat16, "sm90"), (64, 136, torch.float32, "wide"),
    (64, 128, torch.float32, "fma"), (2048, 1024, torch.bfloat16, None),
])
def test_wide_head_dims_route_to_the_wide_kernels(t, d, dtype, kernel):
    """Head dims above the attention bodies' (256 in bf16, 128 in float32)
    take the kernels of attention_wide.cu at T up to 1024, forward and
    backward; longer sequences are refused, and the fused-qkv entry keeps
    the JAX package's gate."""
    for route in (TA.fwd_route, TA.bwd_route):
        if kernel is None:
            with pytest.raises(ValueError, match="ROADMAP queue 2, item 1"):
                route(dtype, d, t=t)
        else:
            assert route(dtype, d, t=t) == kernel
        if d > 128:
            with pytest.raises(ValueError, match="gate"):
                route(dtype, d, fused=True, t=t)
    assert not (kernel == "wide" and TA._qkv_kernel_takes(t, d))


def test_wide_head_dim_matches_jax():
    """inria64's middle attention at B 1 (T 64, one head of D 1024), float32:
    the port's auto path (the plain versions on the CPU, the wide kernels on
    the card) against the JAX package's attention_from_qkv (XLA's einsum
    below T 512), forward and gradient."""
    rng = np.random.default_rng(11)
    qkv = rng.normal(size=(1, 64, 3 * 1024)).astype(np.float32)
    g = rng.normal(size=(1, 64, 1024)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: JA.attention_from_qkv(x, 1), jnp.asarray(qkv))
    (ref_grad,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(qkv).requires_grad_()
    out = TA.attention_from_qkv(x, 1)
    (grad,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    assert _rel(out, ref) <= REL_TOL and _rel(grad, ref_grad) <= REL_TOL


def test_bf16_forward_matches_pallas(regime):
    """q*s and k*s round in bf16 on both sides (ragged T)."""
    q, k, v = _bthd(1, 40, 2, 16, seed=1)
    ref = JA.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), 16, 16)
    out = TA.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert _rel(out, ref.astype(jnp.float32)) <= BF16_TOL


@pytest.mark.parametrize("t,bq,bk", SHAPES)
def test_lse_matches_resident_kernel(t, bq, bk):
    q, k, v = _bthd(2, t, 2, 16, seed=t + 2)
    o_ref, lse_ref = JA._flash_fwd_impl(*map(jnp.asarray, (q, k, v)), bq, bk, return_lse=True)
    out, lse = TA.reference_attention(*map(torch.from_numpy, (q, k, v)), return_lse=True)
    assert lse.shape == (4, t)
    assert _rel(lse, np.asarray(lse_ref)[:, :t, 0]) <= REL_TOL
    assert _rel(out, o_ref) <= REL_TOL


def test_fused_attention_and_plain_impl():
    q, k, v = _bthd(1, 24, 3, 8, seed=9)
    ref = JA.fused_attention(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    assert _rel(TA.fused_attention(qt, kt, vt), ref) <= REL_TOL
    assert torch.equal(TA.flash_attention(qt, kt, vt, impl="plain"),
                       TA.reference_attention(qt, kt, vt))
    with pytest.raises(ValueError):
        TA.flash_attention(qt, kt, vt, impl="pallas")


def _graph_names(out, depth=3):
    """Names of the autograd nodes within ``depth`` steps of ``out``."""
    names, level = set(), [out.grad_fn]
    for _ in range(depth):
        level = [f for f in level if f is not None]
        names |= {type(f).__name__ for f in level}
        level = [n for f in level for n, _ in f.next_functions]
    return names


def _jax_gate(t, d):
    """attention_from_qkv's gate in front of K1 (eo_diffusion_tpu/ops/
    attention.py:927-935) at its default blocks, as written there."""
    block_q = t if t <= 1024 else 512
    bq, bk = min(block_q, t), min(2048, t)
    return (t % bq == 0 and t % bk == 0 and bq % 8 == 0 and d <= 128
            and t <= JA._MAX_RESIDENT_KV)


# the clouds UNet's attention shapes at 256, 384 and 512 px, and the edges
@pytest.mark.parametrize("t,d,takes", [
    (4096, 48, True), (1024, 64, True),      # 256 px: ds 4, ds 8
    (9216, 48, False), (2304, 64, False),    # 384 px
    (16384, 48, False), (4096, 64, True),    # 512 px
    (1536, 64, True), (3072, 64, False), (100, 64, False), (64, 136, False),
    (256, 48, True), (64, 64, True), (40, 16, True)])
def test_qkv_gate_matches_jax(t, d, takes):
    assert TA._qkv_kernel_takes(t, d) == _jax_gate(t, d) == takes


@pytest.mark.parametrize("new_order", [False, True])
def test_unaligned_t_routes_through_flash_and_matches_jax(new_order):
    """T 100 fails the gate: the port takes FlashAttention on the split_qkv
    views, and the gradient reaches qkv through them."""
    rng = np.random.default_rng(4 + new_order)
    qkv = rng.normal(size=(1, 100, 3 * 2 * 16)).astype(np.float32)
    g = rng.normal(size=(1, 100, 32)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: JA.attention_from_qkv(x, 2, new_order=new_order, impl="xla"),
                       jnp.asarray(qkv))
    (ref_grad,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(qkv).requires_grad_()
    out = TA.attention_from_qkv(x, 2, new_order=new_order)
    assert "FlashAttentionBackward" in _graph_names(out)
    assert "QKVAttentionBackward" not in _graph_names(out)
    assert _rel(out, ref) <= REL_TOL
    (grad,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    assert _rel(grad, ref_grad) <= REL_TOL
    # an aligned T keeps the fused-qkv route
    aligned = TA.attention_from_qkv(x[:, :64], 2, new_order=new_order)
    assert "QKVAttentionBackward" in _graph_names(aligned)
    assert "FlashAttentionBackward" not in _graph_names(aligned)


def test_cpu_never_launches_the_flash_kernels():
    q, k, v = (torch.from_numpy(x) for x in _bthd(1, 16, 2, 8, seed=0))
    TA.flash_attention(q, k, v)
    TA.attention_from_qkv(torch.randn(1, 20, 48), 2)
    assert TA.flash_attention_cuda.launches == TA.flash_attention_bwd_cuda.launches == 0
    with pytest.raises(ValueError):  # the wrappers take CUDA tensors only
        TA.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError):
        TA.flash_attention_bwd_cuda(q, k, v, q, torch.zeros(2, 16), q)
