"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc`` and skip without
them. Run them on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

The shapes here are small and cover the dispatch cases (every head dim the
kernel takes, both head orders, ragged T, strided inputs, float32);
``chip_smoke.py`` holds the kernels at the main path's full shapes.
"""

import dataclasses

import pytest
import torch

from eo_diffusion_torch.models import unet as TU
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.weights import randomize_parameters

pytestmark = pytest.mark.cuda

# |kernel - plain| / max(1, |plain|), elementwise. bf16: both round their
# output to bf16 (one ulp, 2^-8 relative) and the kernel rounds p to bf16
# before PV; float32 (TF32 off) differs only in summation order.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, t, heads, d, dtype, seed, pad=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    full = 2.0 * torch.randn(b, t, 3 * heads * d + pad, generator=g, device="cuda")
    return full.to(dtype)[:, :, :3 * heads * d]  # pad > 0: a strided view


def _check(qkv, heads, new_order, with_lse=False):
    out = A.attention_from_qkv(qkv, heads, new_order, return_lse=with_lse)
    ref = A.attention_from_qkv(qkv, heads, new_order, impl="plain", return_lse=with_lse)
    torch.cuda.synchronize()
    if with_lse:
        (out, lse), (ref, ref_lse) = out, ref
        assert lse.shape == ref_lse.shape and lse.dtype == torch.float32
        assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert out.shape == ref.shape and out.dtype == qkv.dtype
    err = ((out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
    assert err <= TOL[qkv.dtype], err


@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_every_head_dim_bf16(dev, d):
    _check(_qkv(2, 77, 2, d, torch.bfloat16, seed=d), 2, new_order=d % 16 == 0)


@pytest.mark.parametrize("d", [32, 48, 64, 128])
@pytest.mark.parametrize("new_order", [False, True])
def test_float32(dev, d, new_order):
    _check(_qkv(2, 130, 2, d, torch.float32, seed=d), 2, new_order)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ragged_t_strided_and_lse(dev, t, dtype):
    _check(_qkv(3, t, 4, 48, dtype, seed=t, pad=8), 4, new_order=True, with_lse=True)


def test_launch_counter_and_refusals(dev):
    qkv = _qkv(1, 64, 2, 64, torch.bfloat16, seed=0)
    before = A.qkv_attention_cuda.launches
    A.attention_from_qkv(qkv, 2)
    A.attention_from_qkv(qkv, 2, impl="plain")
    assert A.qkv_attention_cuda.launches == before + 1
    with pytest.raises(ValueError):  # head dim 12: not a multiple of 8
        A.attention_from_qkv(_qkv(1, 16, 2, 12, torch.bfloat16, seed=1), 2)
    with pytest.raises(ValueError):  # head dim 136 > 128: the fused-qkv entry keeps JAX's gate
        A.qkv_attention_cuda(_qkv(1, 16, 1, 136, torch.bfloat16, seed=1), 1)
    # head dim 264 > 256 (through the separate-tensor route): the wide kernel
    # up to T 1024, refused above
    wide = A.wide_attention_cuda.launches
    A.attention_from_qkv(_qkv(1, 16, 1, 264, torch.bfloat16, seed=1), 1)
    assert A.wide_attention_cuda.launches == wide + 1
    with pytest.raises(ValueError):
        A.attention_from_qkv(_qkv(1, 1040, 1, 264, torch.bfloat16, seed=1), 1)
    with pytest.raises(ValueError):
        A.attention_from_qkv(qkv.half(), 2)
    assert A.qkv_attention_cuda.launches == before + 1


@pytest.mark.parametrize("new_order", [False, True])
def test_unet_forward_kernel_matches_plain(dev, new_order):
    cfg = TU.UNetConfig(image_size=16, in_channels=3, model_channels=32, out_channels=3,
                        num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                        num_heads=2, use_new_attention_order=new_order)
    model = randomize_parameters(TU.UNet(cfg), seed=0).to(dev).eval()
    plain = randomize_parameters(TU.UNet(dataclasses.replace(cfg, attn_impl="plain")),
                                 seed=0).to(dev).eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 16, 16, 3, generator=g, device="cuda")
    t = torch.tensor([3, 700], device="cuda")
    before = A.qkv_attention_cuda.launches
    with torch.inference_mode():
        out, ref = model(x, t), plain(x, t)
    plan = TU.build_unet_plan(cfg)
    n_attn = sum(s.kind == "attn" for blk in (*plan.input_blocks, plan.middle_block,
                                               *plan.output_blocks) for s in blk)
    assert A.qkv_attention_cuda.launches - before == n_attn == 7
    # float32 model: kernel and plain attention agree to summation order
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-4


# -- the backward kernel --------------------------------------------------------

# |kernel - plain| <= TOL_BWD * max(1, |plain|) after dividing both by the rms
# of the whole gradient (dq, dk, dv together): both follow one recipe (p and ds rounded to the input dtype,
# f32 accumulation, one final rounding), so bf16 differs by an output ulp
# (2^-8 relative) plus the ulps of p and ds where an f32 value sat on a
# rounding boundary; float32 differs in summation order and in exp's last bits.
TOL_BWD = {torch.bfloat16: 4e-2, torch.float32: 2e-4}


def _check_bwd(qkv, heads, new_order):
    out, lse = A.qkv_attention_cuda(qkv, heads, new_order, return_lse=True)
    g = torch.Generator(device="cuda").manual_seed(7)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(qkv.dtype)
    before = A.qkv_attention_bwd_cuda.launches
    dqkv = A.qkv_attention_bwd_cuda(qkv, out, lse, dout, heads, new_order)
    torch.cuda.synchronize()
    assert A.qkv_attention_bwd_cuda.launches == before + 1
    assert dqkv.shape == qkv.shape and dqkv.dtype == qkv.dtype and dqkv.is_contiguous()
    b, t, c = out.shape
    shape = (b, t, heads, c // heads)
    ref = A.reference_attention_bwd(*A.split_qkv(qkv, heads, new_order), out.reshape(shape),
                                    lse, dout.reshape(shape))
    rms = torch.stack([r.float() for r in ref]).pow(2).mean().sqrt().clamp(min=1e-12)
    for name, got, want in zip("qkv", A.split_qkv(dqkv, heads, new_order), ref):
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all(), name
        err = ((got - want).abs() / rms / (want.abs() / rms).clamp(min=1.0)).max().item()
        assert err <= TOL_BWD[qkv.dtype], (name, err)


@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_bwd_every_head_dim_bf16(dev, d):
    _check_bwd(_qkv(2, 77, 2, d, torch.bfloat16, seed=d), 2, new_order=d % 16 == 0)


@pytest.mark.parametrize("d", [32, 48, 64, 128])
@pytest.mark.parametrize("new_order", [False, True])
def test_bwd_float32(dev, d, new_order):
    _check_bwd(_qkv(2, 130, 2, d, torch.float32, seed=d), 2, new_order)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_ragged_t_and_strided(dev, t, dtype):
    _check_bwd(_qkv(3, t, 4, 48, dtype, seed=t, pad=8), 4, new_order=True)


def test_bwd_is_reproducible_and_refuses(dev):
    qkv = _qkv(2, 200, 2, 48, torch.bfloat16, seed=3)
    out, lse = A.qkv_attention_cuda(qkv, 2, return_lse=True)
    dout = torch.ones_like(out)
    a = A.qkv_attention_bwd_cuda(qkv, out, lse, dout, 2)
    b = A.qkv_attention_bwd_cuda(qkv, out, lse, dout, 2)
    assert torch.equal(a, b)  # no atomics: the same bits every run
    before = A.qkv_attention_bwd_cuda.launches
    with pytest.raises(ValueError):
        A.qkv_attention_bwd_cuda(qkv, out, lse[:, :-1], dout, 2)
    with pytest.raises(ValueError):
        A.qkv_attention_bwd_cuda(qkv, out.float(), lse, dout, 2)
    with pytest.raises(ValueError):
        A.qkv_attention_bwd_cuda(qkv.cpu(), out, lse, dout, 2)
    assert A.qkv_attention_bwd_cuda.launches == before


@pytest.mark.parametrize("new_order", [False, True])
def test_gradient_reaches_qkv_through_the_kernels(dev, new_order):
    """float32: the Function's gradient (both kernels) equals plain autograd
    through reference_attention, and qkv gets one at all."""
    qkv = _qkv(2, 96, 2, 32, torch.float32, seed=5).clone().requires_grad_()
    g = torch.Generator(device="cuda").manual_seed(6)
    dout = torch.randn(2, 96, 64, generator=g, device="cuda")
    f0, b0 = A.qkv_attention_cuda.launches, A.qkv_attention_bwd_cuda.launches
    (got,) = torch.autograd.grad(A.attention_from_qkv(qkv, 2, new_order), qkv, dout)
    assert (A.qkv_attention_cuda.launches, A.qkv_attention_bwd_cuda.launches) == (f0 + 1, b0 + 1)
    (want,) = torch.autograd.grad(A.attention_from_qkv(qkv, 2, new_order, impl="plain"),
                                  qkv, dout)
    assert got.abs().max().item() > 0
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4


def test_unet_backward_gives_attention_weights_a_gradient(dev):
    cfg = TU.UNetConfig(image_size=16, in_channels=3, model_channels=32, out_channels=3,
                        num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                        num_heads=2)
    model = randomize_parameters(TU.UNet(cfg), seed=0).to(dev)
    plain = randomize_parameters(TU.UNet(dataclasses.replace(cfg, attn_impl="plain")),
                                 seed=0).to(dev)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 16, 16, 3, generator=g, device="cuda")
    t = torch.tensor([3, 700], device="cuda")
    b0 = A.qkv_attention_bwd_cuda.launches
    model(x, t).square().mean().backward()
    plain(x, t).square().mean().backward()
    assert A.qkv_attention_bwd_cuda.launches - b0 == 7
    named, ref = dict(model.named_parameters()), dict(plain.named_parameters())
    # float32 model: the two gradient sets agree to summation order. A bias in
    # front of a GroupNorm whose groups hold one channel has a zero gradient
    # up to rounding noise: hold a leaf against 1e-2 of the mean leaf norm
    # where its own norm is smaller
    floor = 1e-2 * sum(q.grad.norm().item() for q in ref.values()) / len(ref)
    for name, p in named.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if name.endswith("qkv.weight"):
            assert p.grad.abs().max().item() > 0, name
        q = ref[name]
        rel = ((p.grad - q.grad).norm() / q.grad.norm().clamp(min=floor)).item()
        assert rel <= 1e-3, (name, rel)


# -- the GroupNorm kernel (K5) ---------------------------------------------------

from eo_diffusion_torch.ops import group_norm as G  # noqa: E402

# forward, |kernel - plain| <= TOL_GN * max(1, |plain|) elementwise: both compute
# in f32 from the same inputs and round once, so bf16 differs by at most one
# output ulp (2^-7 relative) where the two f32 values straddle a rounding
# boundary; f32 by the order of the sums (the mean-100 case moves the mean by
# ulps of 100) and expf/rsqrtf's last bits.
TOL_GN = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# backward: dx like the forward against max(rms of dx, |plain|); dgamma and
# dbeta are f32 sums over HW in another order, held at 1e-3 of max(rms, |plain|)
TOL_GN_PARAMS = 1e-3


def _gn_inputs(n, hw, c, dtype, seed, loc=0.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (loc + torch.randn(n, hw, c, generator=g, device="cuda")).to(dtype)
    gamma = 1 + 0.1 * torch.randn(n, c, generator=g, device="cuda")
    beta = 0.1 * torch.randn(n, c, generator=g, device="cuda")
    dy = torch.randn(n, hw, c, generator=g, device="cuda").to(dtype)
    return x, gamma, beta, dy


def _scaled_err(got, want, floor):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return ((got - want).abs() / want.abs().clamp(min=floor)).max().item()


def _check_gn(x, gamma, beta, dy, groups, act):
    f0, b0 = G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches
    y, mean, rstd = G.group_norm_fwd_cuda(x, gamma, beta, groups, 1e-5, act)
    dx, dgamma, dbeta = G.group_norm_bwd_cuda(x, gamma, beta, mean, rstd, dy, groups, act)
    torch.cuda.synchronize()
    assert (G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches) == (f0 + 1, b0 + 1)
    assert y.shape == dx.shape == x.shape and y.dtype == dx.dtype == x.dtype
    ref_mean, ref_rstd = G._stats(x, groups, 1e-5)
    assert (mean - ref_mean).abs().max().item() <= 1e-4 * max(1.0, ref_mean.abs().max().item())
    assert ((rstd - ref_rstd).abs() / ref_rstd).max().item() <= 1e-4
    ref = G.group_norm_reference(x, gamma, beta, groups, act=act)
    assert _scaled_err(y, ref, 1.0) <= TOL_GN[x.dtype]
    rdx, rdgamma, rdbeta = G.group_norm_backward_reference(x, gamma, beta, mean, rstd, dy,
                                                           groups, act)
    assert _scaled_err(dx, rdx, rdx.float().pow(2).mean().sqrt().item()) <= TOL_GN[x.dtype]
    for got, want in ((dgamma, rdgamma), (dbeta, rdbeta)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _scaled_err(got, want, want.pow(2).mean().sqrt().item()) <= TOL_GN_PARAMS


# (HW, C, groups): the UNet's widths (C/G 4 ... 32, and 12, 16), narrow ones
# (24 in 24 groups, 8 in 8), ragged HW, a width that is not a multiple of 8
@pytest.mark.parametrize("hw,c,groups", [(1024, 128, 32), (256, 384, 32), (64, 1024, 32),
                                         (100, 24, 24), (33, 8, 8), (17, 36, 12),
                                         (4096, 64, 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_group_norm_kernels_match_plain(dev, hw, c, groups, dtype, act):
    _check_gn(*_gn_inputs(2, hw, c, dtype, seed=hw + c), groups, act)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_mean_100_and_one_sample(dev, dtype):
    """|mean| >> std: the shifted sums and Chan's combine keep the variance."""
    _check_gn(*_gn_inputs(1, 9000, 64, dtype, seed=3, loc=100.0), 32, "silu")


def test_group_norm_is_reproducible_and_refuses(dev):
    x, gamma, beta, dy = _gn_inputs(3, 500, 96, torch.bfloat16, seed=4)
    y1, m1, r1 = G.group_norm_fwd_cuda(x, gamma, beta, 32, act="silu")
    y2, m2, r2 = G.group_norm_fwd_cuda(x, gamma, beta, 32, act="silu")
    assert torch.equal(y1, y2) and torch.equal(m1, m2) and torch.equal(r1, r2)
    a = G.group_norm_bwd_cuda(x, gamma, beta, m1, r1, dy, 32, "silu")
    b = G.group_norm_bwd_cuda(x, gamma, beta, m1, r1, dy, 32, "silu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))  # no atomics: the same bits
    f0, b0 = G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches
    with pytest.raises(ValueError):  # 96 channels do not split into 36 groups
        G.group_norm_fwd_cuda(x, gamma, beta, 36)
    with pytest.raises(ValueError):
        G.group_norm_fwd_cuda(x.half(), gamma, beta, 32)
    with pytest.raises(ValueError):
        G.group_norm_fwd_cuda(x, gamma.bfloat16(), beta, 32)
    with pytest.raises(ValueError):
        G.group_norm_bwd_cuda(x, gamma, beta, m1[:, :-1], r1, dy, 32)
    with pytest.raises(RuntimeError):  # 4099 odd channels: wider than a block
        G.group_norm_fwd_cuda(torch.zeros(1, 4, 4099, device="cuda"),
                              torch.ones(1, 4099, device="cuda"),
                              torch.zeros(1, 4099, device="cuda"), 1)
    assert (G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches) == (f0, b0)


@pytest.mark.parametrize("film", [False, True])
def test_group_norm_autograd_matches_plain(dev, film):
    """fused_group_norm on the card (GroupNormFn: both kernels) against plain
    autograd through group_norm_reference, gamma/beta [C] or FiLM-folded."""
    x, _, _, dy = _gn_inputs(2, 300, 64, torch.float32, seed=5)
    w = (1 + 0.1 * torch.randn(64, device="cuda")).requires_grad_()
    b = (0.1 * torch.randn(64, device="cuda")).requires_grad_()
    s, t = 0.2 * torch.randn(2, 64, device="cuda"), 0.2 * torch.randn(2, 64, device="cuda")
    x = x.requires_grad_()

    def run(impl):
        ga, be = (w * (1 + s), b * (1 + s) + t) if film else (w, b)
        y = G.fused_group_norm(x, ga, be, 32, act="silu", impl=impl)
        return torch.autograd.grad(y, (x, w, b), dy)

    f0, b0 = G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches
    got = run("auto")
    assert (G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches) == (f0 + 1, b0 + 1)
    want = run("plain")
    assert (G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches) == (f0 + 1, b0 + 1)
    for a, r in zip(got, want):
        assert ((a - r).abs().max() / r.abs().max()).item() <= 1e-4


def test_unet_norms_go_through_the_kernels(dev):
    """Every GroupNorm of a UNet forward and backward on the card launches
    K5; the all-plain model (set_impl) launches none and agrees."""
    cfg = TU.UNetConfig(image_size=16, in_channels=3, model_channels=32, out_channels=3,
                        num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                        num_heads=2, use_scale_shift_norm=True)
    model = randomize_parameters(TU.UNet(cfg), seed=0).to(dev)
    plan = TU.build_unet_plan(cfg)
    kinds = [s.kind for blk in (*plan.input_blocks, plan.middle_block, *plan.output_blocks)
             for s in blk]
    sites = 2 * kinds.count("res") + kinds.count("attn") + 1
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 16, 16, 3, generator=g, device="cuda")
    t = torch.tensor([3, 700], device="cuda")
    grads = {}
    for impl in ("auto", "plain"):
        model.set_impl(attn=impl, norm=impl).zero_grad(set_to_none=True)
        f0, b0 = G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches
        model(x, t).square().mean().backward()
        launched = (G.group_norm_fwd_cuda.launches - f0, G.group_norm_bwd_cuda.launches - b0)
        assert launched == ((sites, sites) if impl == "auto" else (0, 0)), launched
        grads[impl] = {n: p.grad.clone() for n, p in model.named_parameters()}
    floor = 1e-2 * sum(v.norm().item() for v in grads["plain"].values()) / len(grads["plain"])
    for name, got in grads["auto"].items():
        want = grads["plain"][name]
        assert ((got - want).norm() / want.norm().clamp(min=floor)).item() <= 1e-3, name


# the one-launch body (group_norm_sm90.cu): each mode its planner picks, the
# edges of its chunking, and its refusals

@pytest.mark.parametrize("n,hw,c,groups,dtype,mode", [
    (2, 1024, 128, 32, torch.bfloat16, "resident"),
    (8, 16384, 256, 32, torch.bfloat16, "l2"),
    (8, 262144, 128, 32, torch.bfloat16, "hbm"),
])
def test_group_norm_sm90_each_mode_matches_plain(dev, n, hw, c, groups, dtype, mode):
    x, gamma, beta, dy = _gn_inputs(n, hw, c, dtype, seed=7)
    assert G._card_plan("fwd", x, n, hw, c, groups)[0].mode == mode
    _check_gn(x, gamma, beta, dy, groups, "silu")


@pytest.mark.parametrize("n,hw,c,groups", [(3, 1000, 128, 32), (2, 4097, 64, 32),
                                           (5, 3, 128, 32), (7, 1, 32, 8), (64, 5, 96, 32)])
def test_group_norm_sm90_ragged_and_fewer_rows_than_blocks(dev, n, hw, c, groups):
    """Ragged HW (a short last chunk), and HW smaller than the blocks a team
    would take (a team of HW one-row chunks)."""
    x, gamma, beta, dy = _gn_inputs(n, hw, c, torch.bfloat16, seed=hw)
    p = G._card_plan("fwd", x, n, hw, c, groups)[0]
    assert p.blocks <= hw and (p.blocks - 1) * p.chunk_rows < hw <= p.blocks * p.chunk_rows
    _check_gn(x, gamma, beta, dy, groups, "silu")


@pytest.mark.parametrize("n,hw,c,groups,dtype,loc", [
    (8, 4096, 24, 24, torch.bfloat16, 0.0), (8, 4096, 896, 32, torch.bfloat16, 0.0),
    (2, 16384, 256, 32, torch.float32, 0.0), (2, 65536, 128, 32, torch.float32, 100.0),
    (2, 65536, 256, 32, torch.float32, 0.0)])
def test_group_norm_sm90_widths_f32_and_mean_100(dev, n, hw, c, groups, dtype, loc):
    _check_gn(*_gn_inputs(n, hw, c, dtype, seed=c, loc=loc), groups, "silu")


def test_group_norm_sm90_leaves_its_counters_at_zero(dev):
    """No memset precedes a launch: every launch leaves the teams' counters at
    zero for the next, over plans of other team counts and block counts."""
    for n, hw, c in ((8, 1024, 512), (2, 65536, 128), (3, 17, 64)):
        x, gamma, beta, dy = _gn_inputs(n, hw, c, torch.bfloat16, seed=1)
        y, mean, rstd = G.group_norm_fwd_cuda(x, gamma, beta, 32, act="silu")
        G.group_norm_bwd_cuda(x, gamma, beta, mean, rstd, dy, 32, "silu")
        torch.cuda.synchronize()
        work = G._scratch[(x.device.index, torch.cuda.current_stream().cuda_stream)]
        assert not work[:2 * G.MAX_TEAMS].view(torch.int32).any()


def test_group_norm_sm90_grid_too_large_raises(dev):
    """A plan whose grid the card cannot hold at once is a launch error the
    wrapper raises (the cooperative launch refuses it), never a hang, and the
    next launch runs."""
    import ctypes
    import dataclasses

    n, hw, c = 4, 8 * 132, 128
    x, gamma, beta, dy = _gn_inputs(n, hw, c, torch.bfloat16, seed=2)
    key = ("fwd", n, hw, c, 32, x.dtype, x.device.index)
    good = G._card_plan("fwd", x, n, hw, c, 32)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bad = dataclasses.replace(good[0], teams=4, blocks=sms, chunk_rows=-(-hw // sms),
                              held_rows=0, pieces=0, smem_bytes=200_000,
                              scratch_floats=2 * G.MAX_TEAMS + 4 * 4 * sms * 32)
    G._plans[key] = (bad, (ctypes.c_int * 12)(*bad.ints()))
    f0 = G.group_norm_fwd_cuda.launches
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            G.group_norm_fwd_cuda(x, gamma, beta, 32, act="silu")
    finally:
        G._plans[key] = good
    assert G.group_norm_fwd_cuda.launches == f0
    _check_gn(x, gamma, beta, dy, 32, "silu")


@pytest.mark.parametrize("hw,c,groups,dtype", [(1024, 128, 32, torch.bfloat16),
                                               (17, 36, 12, torch.float32)])
def test_group_norm_old_body_entries_match_plain_and_count_apart(dev, hw, c, groups, dtype):
    """The old three-launch body (group_norm.cu), the new one's yardstick,
    behind its own wrappers and counters."""
    x, gamma, beta, dy = _gn_inputs(2, hw, c, dtype, seed=3)
    counts = lambda: (G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches,
                      G.group_norm_fwd_legacy_cuda.launches,
                      G.group_norm_bwd_legacy_cuda.launches)
    c0 = counts()
    y, mean, rstd = G.group_norm_fwd_legacy_cuda(x, gamma, beta, groups, 1e-5, "silu")
    dx, dgamma, dbeta = G.group_norm_bwd_legacy_cuda(x, gamma, beta, mean, rstd, dy, groups,
                                                     "silu")
    torch.cuda.synchronize()
    assert counts() == (c0[0], c0[1], c0[2] + 1, c0[3] + 1)
    assert _scaled_err(y, G.group_norm_reference(x, gamma, beta, groups, act="silu"),
                       1.0) <= TOL_GN[dtype]
    rdx, rdgamma, rdbeta = G.group_norm_backward_reference(x, gamma, beta, mean, rstd, dy,
                                                           groups, "silu")
    assert _scaled_err(dx, rdx, rdx.float().pow(2).mean().sqrt().item()) <= TOL_GN[dtype]
    assert _scaled_err(dgamma, rdgamma, rdgamma.pow(2).mean().sqrt().item()) <= TOL_GN_PARAMS


def test_unet_norms_never_launch_the_old_body(dev):
    """A UNet forward and backward on the card takes the one-launch body for
    every GroupNorm: the old body's counters do not move."""
    cfg = TU.UNetConfig(image_size=16, in_channels=3, model_channels=32, out_channels=3,
                        num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                        num_heads=2, use_scale_shift_norm=True)
    model = randomize_parameters(TU.UNet(cfg), seed=0).to(dev)
    x = torch.randn(2, 16, 16, 3, device="cuda")
    f0, b0 = G.group_norm_fwd_legacy_cuda.launches, G.group_norm_bwd_legacy_cuda.launches
    n0 = G.group_norm_fwd_cuda.launches
    model(x, torch.tensor([3, 700], device="cuda")).square().mean().backward()
    assert G.group_norm_fwd_cuda.launches > n0
    assert (G.group_norm_fwd_legacy_cuda.launches, G.group_norm_bwd_legacy_cuda.launches) == (
        f0, b0)


# -- the separate-tensor entries (K2/K3 forward, K4 behind them) -----------------


def _planes(b, t, h, d, dtype, seed, layout):
    """q, k, v [B, T, H, D]: strided split_qkv views of one projection in
    either head order, or three contiguous tensors."""
    if layout == "contiguous":
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [(2.0 * torch.randn(b, t, h, d, generator=g, device="cuda")).to(dtype)
                for _ in range(3)]
    return list(A.split_qkv(_qkv(b, t, h, d, dtype, seed), h, layout == "new"))


def _check_flash(q, k, v):
    f0 = A.flash_attention_cuda.launches
    out, lse = A.flash_attention_cuda(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert A.flash_attention_cuda.launches == f0 + 1
    ref, ref_lse = A.reference_attention(q, k, v, return_lse=True)
    assert out.shape == q.shape and out.dtype == q.dtype and out.is_contiguous()
    assert lse.shape == ref_lse.shape and (lse - ref_lse).abs().max().item() <= 1e-3
    err = ((out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
    assert err <= TOL[q.dtype], err
    return out, lse


@pytest.mark.parametrize("t", [1, 63, 100, 2304])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["legacy", "new", "contiguous"])
def test_flash_fwd_and_bwd_match_plain(dev, t, dtype, layout):
    q, k, v = _planes(2, t, 2, 48 if t % 2 else 64, dtype, seed=t, layout=layout)
    out, lse = _check_flash(q, k, v)
    g = torch.Generator(device="cuda").manual_seed(7)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    b0 = A.flash_attention_bwd_cuda.launches
    got = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert A.flash_attention_bwd_cuda.launches == b0 + 1
    ref = A.reference_attention_bwd(q, k, v, out, lse, dout)
    rms = torch.stack([r.float() for r in ref]).pow(2).mean().sqrt().clamp(min=1e-12)
    for name, a, want in zip("qkv", got, ref):
        assert a.shape == q.shape and a.dtype == dtype and a.is_contiguous()
        a, want = a.float(), want.float()
        assert torch.isfinite(a).all(), name
        err = ((a - want).abs() / rms / (want.abs() / rms).clamp(min=1.0)).max().item()
        assert err <= TOL_BWD[dtype], (name, err)


@pytest.mark.parametrize("d", [8, 16, 40, 48, 64, 96, 128])
def test_flash_every_head_dim_bf16(dev, d):
    _check_flash(*_planes(1, 129, 3, d, torch.bfloat16, seed=d, layout="legacy"))


def test_flash_takes_k_and_v_of_different_strides(dev):
    """The kernel reads K and V rows at one token stride: the wrapper copies
    k and v whose token strides differ, and the result still matches."""
    q, k, _ = _planes(2, 77, 2, 48, torch.bfloat16, seed=2, layout="new")
    g = torch.Generator(device="cuda").manual_seed(3)
    v = torch.randn(2, 77, 2, 56, generator=g, device="cuda").to(torch.bfloat16)[..., :48]
    assert k.stride(1) != v.stride(1)
    _check_flash(q, k, v)


def test_flash_matches_the_fused_entry_bit_for_bit(dev):
    """One kernel body behind both entries: the split_qkv views give the
    fused-qkv entry's bits."""
    qkv = _qkv(2, 256, 4, 48, torch.bfloat16, seed=11)
    for new_order in (False, True):
        fused, lse = A.qkv_attention_cuda(qkv, 4, new_order, return_lse=True)
        out, lse2 = A.flash_attention_cuda(*A.split_qkv(qkv, 4, new_order), return_lse=True)
        assert torch.equal(out.reshape(fused.shape), fused) and torch.equal(lse2, lse)


def test_flash_is_reproducible_and_refuses(dev):
    q, k, v = _planes(2, 200, 2, 48, torch.bfloat16, seed=3, layout="new")
    out, lse = A.flash_attention_cuda(q, k, v, return_lse=True)
    dout = torch.ones_like(out)
    a = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    b = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))  # no atomics: the same bits
    f0, b0 = A.flash_attention_cuda.launches, A.flash_attention_bwd_cuda.launches
    # head dims above the bodies' (256 bf16, 128 float32) take the wide
    # kernels up to T 1024; above it they are refused
    big = [torch.zeros(1, 1040, 1, 264, device="cuda", dtype=torch.bfloat16)] * 3
    with pytest.raises(ValueError, match="ROADMAP queue 2, item 1"):  # head dim 264 > 256
        A.flash_attention_cuda(*big)
    with pytest.raises(ValueError, match="K2/K3"):  # float32 takes head dims up to 128
        A.attention_from_qkv(torch.zeros(1, 1040, 3 * 136, device="cuda"), 1)
    d136 = [x[..., :136].float() for x in big]
    with pytest.raises(ValueError, match="ROADMAP queue 2, item 1"):  # no f32 backward above 128
        A.flash_attention_bwd_cuda(*d136, d136[0], torch.zeros(1, 1040, device="cuda"), d136[0])
    with pytest.raises(ValueError):  # head dim 12: not a multiple of 8
        A.flash_attention_cuda(*[x[..., :12] for x in (q, k, v)])
    with pytest.raises(ValueError):
        A.flash_attention_cuda(q, k, v[:, :-1])
    with pytest.raises(ValueError):
        A.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        A.flash_attention_bwd_cuda(q, k, v, out, lse[:, :-1], dout)
    assert (A.flash_attention_cuda.launches, A.flash_attention_bwd_cuda.launches) == (f0, b0)


# -- the wgmma/TMA body beside the mma.sync body it replaced ----------------------

# the probes' limits (chip_smoke.py, probe_packed_pv.attention_errors) at
# unit-normal inputs: TOL of max(rms, |plain|) elementwise, relative L2
TOL_L2 = 5e-3


def _strict(out, ref):
    from eo_diffusion_torch.tools.probe_packed_pv import attention_errors

    e = attention_errors(out, ref)
    assert e["max_rms_scaled_err"] <= TOL[torch.bfloat16] and e["rel_l2_err"] <= TOL_L2, e


# chip_smoke.py phase 3's K1-K3 shapes (B, T, H, D, entry, new order); T 16384
# at batch 1, where the plain version's scores take 8.6 GB a sample
PHASE3 = [(8, 4096, 8, 48, "fused", False), (8, 4096, 8, 48, "fused", True),
          (8, 1024, 8, 64, "fused", False), (8, 1024, 8, 64, "fused", True),
          (8, 256, 8, 48, "fused", False), (8, 64, 8, 64, "fused", False),
          (8, 4096, 8, 64, "fused", False), (3, 1000, 4, 48, "fused", True),
          (8, 1024, 12, 64, "fused", True), (32, 256, 12, 64, "fused", True),
          (8, 256, 6, 64, "fused", True), (1, 16384, 8, 48, "flash", False),
          (2, 9216, 8, 48, "flash", True), (8, 2304, 8, 64, "flash", False),
          (2, 2309, 4, 48, "flash", True), (2, 2309, 4, 160, "flash", False),
          (2, 2309, 4, 256, "flash", True)]


@pytest.mark.parametrize("b,t,h,d,entry,new_order", PHASE3)
def test_sm90_body_matches_plain_at_phase3_shapes(dev, b, t, h, d, entry, new_order):
    qkv = _qkv(b, t, h, d, torch.bfloat16, seed=t + d).float().div_(2.0).to(torch.bfloat16)
    planes = A.split_qkv(qkv, h, new_order)
    counter = A.qkv_attention_cuda if entry == "fused" else A.flash_attention_cuda
    before = (counter.launches, A.qkv_attention_mma_cuda.launches,
              A.flash_attention_mma_cuda.launches)
    if entry == "fused":
        out, lse = A.qkv_attention_cuda(qkv, h, new_order, return_lse=True)
        out = out.reshape(b, t, h, d)
    else:
        out, lse = A.flash_attention_cuda(*planes, return_lse=True)
    assert (counter.launches, A.qkv_attention_mma_cuda.launches,
            A.flash_attention_mma_cuda.launches) == (before[0] + 1, *before[1:])
    for i in range(b):  # a sample at a time: the plain scores of T 16384
        ref, ref_lse = A.reference_attention(*(x[i:i + 1] for x in planes), return_lse=True)
        _strict(out[i:i + 1], ref)
        assert (lse[i * h:(i + 1) * h] - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("d", list(range(136, 257, 8)))
def test_flash_head_dims_above_128_bf16(dev, d):
    _check_flash(*_planes(1, 129, 2, d, torch.bfloat16, seed=d, layout="legacy"))


def test_flash_attention_takes_d256_forward_and_refuses_its_backward(dev):
    """D 256 runs both wgmma/TMA bodies through autograd; float32 above 128
    takes the wide kernels at T up to 1024, and what the backward still
    refuses (those head dims above T 1024) names ROADMAP queue 2, item 1."""
    q, k, v, out, lse, dout = _unit_bwd_inputs(2, 300, 2, 256, seed=4, layout="contiguous")
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        _strict(A.flash_attention(q, k, v), A.reference_attention(q, k, v))
    b0 = A.flash_attention_bwd_cuda.launches
    got = torch.autograd.grad(A.flash_attention(q, k, v), (q, k, v), dout)
    assert A.flash_attention_bwd_cuda.launches == b0 + 1
    # plain from the kernel forward's out and lse, as the backward reads them
    _strict_bwd(got, A.reference_attention_bwd(q, k, v, out, lse, dout))
    f32 = [x.detach()[..., :136].float().requires_grad_() for x in (q, k, v)]
    w0 = A.wide_attention_bwd_cuda.launches
    A.flash_attention(*f32).sum().backward()
    assert A.wide_attention_bwd_cuda.launches == w0 + 1
    long = [torch.zeros(1, 1040, 1, 136, device="cuda", requires_grad=True) for _ in range(3)]
    with pytest.raises(ValueError, match="ROADMAP queue 2, item 1"):
        A.flash_attention(*long).sum().backward()
    assert A.flash_attention_bwd_cuda.launches == b0 + 1


@pytest.mark.parametrize("t", [1, 77, 1000])
@pytest.mark.parametrize("new_order", [False, True])
def test_mma_body_entries_match_plain_and_count_apart(dev, t, new_order):
    """The mma.sync body (the probes' yardstick) through its own entries."""
    qkv = _qkv(2, t, 2, 48, torch.bfloat16, seed=t)
    counts = lambda: (A.qkv_attention_cuda.launches, A.flash_attention_cuda.launches,
                      A.qkv_attention_mma_cuda.launches, A.flash_attention_mma_cuda.launches)
    before = counts()
    fused, lse = A.qkv_attention_mma_cuda(qkv, 2, new_order, return_lse=True)
    flash = A.flash_attention_mma_cuda(*A.split_qkv(qkv, 2, new_order))
    assert counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    ref, ref_lse = A.attention_from_qkv(qkv, 2, new_order, impl="plain", return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(flash.reshape(fused.shape), fused)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    err = ((fused.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
    assert err <= TOL[torch.bfloat16], err


def test_mma_body_refuses_above_128(dev):
    big = [torch.zeros(1, 16, 1, 136, device="cuda", dtype=torch.bfloat16)] * 3
    with pytest.raises(ValueError):
        A.flash_attention_mma_cuda(*big)


@pytest.mark.parametrize("new_order", [False, True])
def test_gradient_reaches_qkv_through_the_flash_route(dev, new_order):
    """T 100 fails the fused-qkv gate: attention_from_qkv takes FlashAttention
    on the split_qkv views (both kernels), and qkv gets the plain gradient."""
    qkv = _qkv(2, 100, 2, 32, torch.float32, seed=5).clone().requires_grad_()
    g = torch.Generator(device="cuda").manual_seed(6)
    dout = torch.randn(2, 100, 64, generator=g, device="cuda")
    counters = (A.flash_attention_cuda, A.flash_attention_bwd_cuda, A.qkv_attention_cuda,
                A.qkv_attention_bwd_cuda)
    before = [c.launches for c in counters]
    out = A.attention_from_qkv(qkv, 2, new_order)
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "FlashAttentionBackward"
    (got,) = torch.autograd.grad(out, qkv, dout)
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 0, 0]
    (want,) = torch.autograd.grad(A.attention_from_qkv(qkv, 2, new_order, impl="plain"),
                                  qkv, dout)
    assert got.abs().max().item() > 0
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4


# -- the wgmma/TMA backward beside the mma.sync body it replaced -------------------

# the backward's limits at unit-normal inputs (chip_smoke.py): TOL_BWD of
# max(rms, |plain|) elementwise and a relative L2 of TOL_BWD_L2, both over dq,
# dk and dv together. Kernel and plain follow one recipe, so they differ
# where an f32 value straddles a bf16 rounding (p, ds, the outputs), far
# below the 1e-2 that a gradient 1 % off reads
TOL_BWD_L2 = 5e-3


def _strict_bwd(got, want):
    from eo_diffusion_torch.tools.probe_packed_pv import attention_errors

    for a in got:
        assert torch.isfinite(a.float()).all()
    e = attention_errors(torch.cat([a.flatten() for a in got]),
                         torch.cat([w.flatten() for w in want]))
    assert e["max_rms_scaled_err"] <= TOL_BWD[torch.bfloat16], e
    assert e["rel_l2_err"] <= TOL_BWD_L2, e


def _unit_bwd_inputs(b, t, h, d, seed, layout):
    """Unit-normal bf16 q, k, v in ``layout``, the forward's out and lse, and
    a unit-normal dout."""
    q, k, v = _planes(b, t, h, d, torch.float32, seed, layout)
    q, k, v = (x.float().div(2.0).to(torch.bfloat16) for x in (q, k, v))
    if layout != "contiguous":  # keep the split_qkv views' strides
        qkv = A.stack_qkv(q, k, v, layout == "new")
        q, k, v = A.split_qkv(qkv, h, layout == "new")
    out, lse = A.flash_attention_cuda(q, k, v, return_lse=True)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
    return q, k, v, out, lse, dout


@pytest.mark.parametrize("d", list(range(8, 257, 8)))
def test_sm90_bwd_every_head_dim(dev, d):
    """The separate-tensor entry at every head dim it takes, a ragged T, the
    split_qkv views of either head order: held at unit-normal inputs."""
    q, k, v, out, lse, dout = _unit_bwd_inputs(2, 133, 2, d, seed=d,
                                               layout="new" if d % 16 else "legacy")
    counts = (A.flash_attention_bwd_cuda.launches, A.flash_attention_bwd_mma_cuda.launches)
    got = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert (A.flash_attention_bwd_cuda.launches,
            A.flash_attention_bwd_mma_cuda.launches) == (counts[0] + 1, counts[1])
    _strict_bwd(got, A.reference_attention_bwd(q, k, v, out, lse, dout))


@pytest.mark.parametrize("t", [1, 31, 64, 127, 128, 129, 700])
@pytest.mark.parametrize("new_order", [False, True])
def test_sm90_bwd_fused_entry_ragged_t(dev, t, new_order):
    """The fused-qkv entry over ragged T in both head orders, D 48 (three
    16-column chunks) and 64, from a strided qkv view."""
    d = 48 if t % 2 else 64
    qkv = (_qkv(2, t, 3, d, torch.bfloat16, seed=t, pad=8).float() / 2).to(torch.bfloat16)
    out, lse = A.qkv_attention_cuda(qkv, 3, new_order, return_lse=True)
    g = torch.Generator(device="cuda").manual_seed(t)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
    b0 = A.qkv_attention_bwd_cuda.launches
    dqkv = A.qkv_attention_bwd_cuda(qkv, out, lse, dout, 3, new_order)
    assert A.qkv_attention_bwd_cuda.launches == b0 + 1
    shape = (2, t, 3, d)
    ref = A.reference_attention_bwd(*A.split_qkv(qkv, 3, new_order), out.reshape(shape), lse,
                                    dout.reshape(shape))
    _strict_bwd(A.split_qkv(dqkv, 3, new_order), ref)


@pytest.mark.parametrize("d", [48, 64, 128, 160, 256])
def test_sm90_bwd_same_bits_every_run(dev, d):
    """No atomics: repeats give the same bits, and the fused entry the
    separate one's on the split_qkv views (D <= 128)."""
    q, k, v, out, lse, dout = _unit_bwd_inputs(2, 300, 2, d, seed=d, layout="new")
    a = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    for _ in range(3):
        assert all(torch.equal(x, y) for x, y in
                   zip(a, A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)))
    if d <= 128:
        qkv = A.stack_qkv(q, k, v, new_order=True)
        dqkv = A.qkv_attention_bwd_cuda(qkv, out.reshape(2, 300, -1), lse,
                                        dout.reshape(2, 300, -1), 2, new_order=True)
        assert all(torch.equal(x, y) for x, y in zip(A.split_qkv(dqkv, 2, True), a))


@pytest.mark.parametrize("t", [77, 1000])
@pytest.mark.parametrize("new_order", [False, True])
def test_mma_bwd_entries_match_plain_and_count_apart(dev, t, new_order):
    """The mma.sync backward (the new body's yardstick) through its own
    entries and counters."""
    qkv = (_qkv(2, t, 2, 48, torch.bfloat16, seed=t).float() / 2).to(torch.bfloat16)
    out, lse = A.qkv_attention_cuda(qkv, 2, new_order, return_lse=True)
    g = torch.Generator(device="cuda").manual_seed(t)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
    counters = (A.qkv_attention_bwd_cuda, A.flash_attention_bwd_cuda,
                A.qkv_attention_bwd_mma_cuda, A.flash_attention_bwd_mma_cuda)
    before = [c.launches for c in counters]
    dqkv = A.qkv_attention_bwd_mma_cuda(qkv, out, lse, dout, 2, new_order)
    planes = A.split_qkv(qkv, 2, new_order)
    shape = (2, t, 2, 48)
    flash = A.flash_attention_bwd_mma_cuda(*planes, out.reshape(shape), lse,
                                           dout.reshape(shape))
    assert [c.launches - n for c, n in zip(counters, before)] == [0, 0, 1, 1]
    assert all(torch.equal(x, y) for x, y in zip(A.split_qkv(dqkv, 2, new_order), flash))
    _strict_bwd(flash, A.reference_attention_bwd(*planes, out.reshape(shape), lse,
                                                 dout.reshape(shape)))


def test_sm90_bwd_refuses(dev):
    q, k, v, out, lse, dout = _unit_bwd_inputs(1, 40, 1, 64, seed=1, layout="contiguous")
    before = (A.flash_attention_bwd_cuda.launches, A.qkv_attention_bwd_cuda.launches,
              A.flash_attention_bwd_mma_cuda.launches)
    big = torch.zeros(1, 16, 1, 264, device="cuda", dtype=torch.bfloat16)
    # above wgmma's N: the wide kernels take T up to 1024, longer is refused
    wide = torch.zeros(1, 1040, 1, 264, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP queue 2, item 1"):
        A.flash_attention_bwd_cuda(wide, wide, wide, wide, torch.zeros(1, 1040, device="cuda"),
                                   wide)
    o136 = big[..., :136].reshape(1, 16, 136)
    qkv136 = torch.zeros(1, 16, 3 * 136, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # the fused entry keeps the JAX package's gate
        A.qkv_attention_bwd_cuda(qkv136, o136, torch.zeros(1, 16, device="cuda"), o136, 1)
    with pytest.raises(ValueError):  # the mma.sync body stops at 128
        d136 = big[..., :136]
        A.flash_attention_bwd_mma_cuda(d136, d136, d136, d136,
                                       torch.zeros(1, 16, device="cuda"), d136)
    with pytest.raises(ValueError):
        A.flash_attention_bwd_cuda(q, k, v, out, lse[:, :-1], dout)
    with pytest.raises(ValueError):
        A.flash_attention_bwd_cuda(q, k, v, out.float(), lse, dout)
    assert (A.flash_attention_bwd_cuda.launches, A.qkv_attention_bwd_cuda.launches,
            A.flash_attention_bwd_mma_cuda.launches) == before


# the clouds UNet's attention launches a forward: (flash, fused-qkv)
ROUTES = {256: (0, 11), 384: (11, 0), 512: (5, 6)}


@pytest.mark.parametrize("size", [384, 512])
def test_unet_routes_at_384_and_512_px(dev, size):
    model = randomize_parameters(TU.UNet(TU.unet_clouds(size, dtype=torch.bfloat16)),
                                 seed=0).to(dev).eval()
    x = torch.randn(1, size, size, 3, device="cuda")
    t = torch.tensor([500], device="cuda")
    f0, q0 = A.flash_attention_cuda.launches, A.qkv_attention_cuda.launches
    with torch.inference_mode():
        out = model(x, t)
        torch.cuda.synchronize()
        assert (A.flash_attention_cuda.launches - f0, A.qkv_attention_cuda.launches - q0) \
            == ROUTES[size]
        assert out.shape == (1, size, size, 3) and torch.isfinite(out.float()).all()
        model.set_impl(attn="plain")
        model(x, t)
        assert (A.flash_attention_cuda.launches - f0, A.qkv_attention_cuda.launches - q0) \
            == ROUTES[size]


# -- the W8A8 attention probe kernel --------------------------------------------


@pytest.mark.parametrize("bh,t,d,dtype", [(48, 256, 64, torch.bfloat16), (4, 256, 64, torch.float32),
                                          (2, 128, 32, torch.bfloat16), (5, 32, 64, torch.float32),
                                          (2, 96, 32, torch.float32)])
def test_int8_kernel_matches_plain(dev, bh, t, d, dtype):
    from eo_diffusion_torch.ops import int8_attention as I8

    g = torch.Generator(device="cuda").manual_seed(t + d)
    q, k, v = (torch.randn(bh, t, d, generator=g, device="cuda").to(dtype) for _ in range(3))
    q[0] *= 4.0  # a sharp softmax: l near 1, where one step of round(p * 127) shows most
    before = I8.int8_attention_cuda.launches
    out = I8.int8_attention(q, k, v)
    plain, l, s_v = I8.int8_attention_reference(q, k, v, return_stats=True)
    torch.cuda.synchronize()
    assert I8.int8_attention_cuda.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    diff = (out.float() - plain.float()).abs()
    assert bool((diff <= I8.tolerance(plain, l, s_v)).all()), diff.max().item()
    # the bound is for rare rounding steps; the bulk agrees to the output's ulp
    assert (diff > 2.0 ** -7 * plain.float().abs()).float().mean().item() < 1e-2
    # a strided view is copied, not misread
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(I8.int8_attention(qt, k, v), out)


def test_int8_kernel_refuses_what_it_does_not_take(dev):
    from eo_diffusion_torch.ops import int8_attention as I8

    before = I8.int8_attention_cuda.launches
    for shape in ((2, 48, 64), (2, 512, 64), (2, 64, 48), (2, 64, 128)):
        x = torch.zeros(shape, device="cuda")
        with pytest.raises(ValueError):
            I8.int8_attention(x, x, x)
    x = torch.zeros(2, 64, 64, device="cuda", dtype=torch.half)
    with pytest.raises(ValueError):
        I8.int8_attention(x, x, x)
    assert I8.int8_attention_cuda.launches == before
    I8.int8_attention(*(torch.zeros(2, 64, 64, device="cuda"),) * 3, impl="plain")
    assert I8.int8_attention_cuda.launches == before


# -- the DiT ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dit_forward_kernel_matches_plain_and_launches_k1_a_block(dev, dtype):
    from eo_diffusion_torch.models import dit as TD

    cfg = TD.DiTConfig(image_size=64, in_channels=3, out_channels=3, patch_size=4,
                       hidden_size=256, depth=3, num_heads=4, num_classes=5, dtype=dtype)
    model = randomize_parameters(TD.DiT(cfg), seed=0).to(dev).eval()
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2, 64, 64, 3, generator=g, device="cuda")
    t = torch.tensor([999.0, 31.5], device="cuda")
    y = torch.tensor([1, 4], device="cuda")
    q0, f0 = A.qkv_attention_cuda.launches, A.flash_attention_cuda.launches
    with torch.inference_mode():
        out = model(x, t, y=y).float()
        assert (A.qkv_attention_cuda.launches - q0, A.flash_attention_cuda.launches - f0) \
            == (cfg.depth, 0)  # T 256, D 64: the fused-qkv kernel, one a block
        ref = model.set_impl("plain")(x, t, y=y).float()
        assert A.qkv_attention_cuda.launches - q0 == cfg.depth
    assert out.shape == (2, 64, 64, 3) and torch.isfinite(out).all()
    rel = ((out - ref).norm() / ref.norm()).item()
    assert rel <= (1e-4 if dtype == torch.float32 else 3e-2), rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dit_flow_training_step_kernels_match_plain(dev, dtype):
    """One flow-matching loss and backward of a small DiT (T 256, D 64, new
    head order): K1 with the lse forward and K4 backward once a block, against
    the all-plain model on the same weights, times and noise; every
    parameter's gradient finite, the qkv weights' non-zero."""
    from eo_diffusion_torch.diffusion.flow import FlowMatching
    from eo_diffusion_torch.models import dit as TD

    cfg = TD.DiTConfig(image_size=64, in_channels=3, out_channels=3, patch_size=4,
                       hidden_size=256, depth=3, num_heads=4, dtype=dtype)
    model = randomize_parameters(TD.DiT(cfg), seed=1).to(dev).train()
    g = torch.Generator(device="cuda").manual_seed(3)
    x0 = torch.randn(2, 64, 64, 3, generator=g, device="cuda")
    noise = torch.randn(2, 64, 64, 3, generator=g, device="cuda")
    t = torch.tensor([0.9, 0.2], device="cuda")
    flow = FlowMatching.create(image_size=64)
    losses, grads = {}, {}
    for impl in ("auto", "plain"):
        model.set_impl(impl).zero_grad(set_to_none=True)
        q0, b0 = A.qkv_attention_cuda.launches, A.qkv_attention_bwd_cuda.launches
        loss = flow.train_loss(lambda a, tt, c, y: model(a, tt), x0, t=t, noise=noise)
        loss.backward()
        launched = (A.qkv_attention_cuda.launches - q0, A.qkv_attention_bwd_cuda.launches - b0)
        assert launched == ((cfg.depth, cfg.depth) if impl == "auto" else (0, 0)), launched
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert abs(losses["auto"] - losses["plain"]) <= tol * abs(losses["plain"])
    num = den = 0.0
    for name, gk in grads["auto"].items():
        assert torch.isfinite(gk).all(), name
        if name.endswith("qkv.weight"):
            assert gk.abs().max() > 0, name
        num += (gk - grads["plain"][name]).pow(2).sum().item()
        den += grads["plain"][name].pow(2).sum().item()
    assert (num / den) ** 0.5 <= tol


# -- the 3x3 conv weight-gradient kernel -----------------------------------------

# |kernel - plain| / max|plain|: both sum exact products of the inputs in f32
# (bf16 inputs) or round each f32 product (f32 inputs); only the order differs
WGRAD_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}


def _wgrad_inputs(b, h, w, c, co, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(b, h, w, c, generator=g, device="cuda").to(dtype),
            torch.randn(b, h, w, co, generator=g, device="cuda").to(dtype))


@pytest.mark.parametrize("b,h,w,c,co,dtype", [
    (2, 16, 16, 64, 64, torch.bfloat16),    # one (c, o) tile
    (1, 20, 27, 40, 24, torch.bfloat16),    # ragged tiles and channels
    (2, 9, 33, 6, 128, torch.bfloat16),     # the input conv's C 6: element loads
    (2, 16, 16, 128, 3, torch.bfloat16),    # the output conv's Co 3
    (3, 32, 48, 128, 192, torch.bfloat16),  # several splits a tile
    (2, 8, 8, 512, 512, torch.bfloat16),    # 64 tile pairs, one dy tile each
    (2, 10, 13, 16, 24, torch.float32)])
def test_wgrad_kernel_matches_plain(dev, b, h, w, c, co, dtype):
    from eo_diffusion_torch.ops import conv_wgrad as CW

    x, dy = _wgrad_inputs(b, h, w, c, co, dtype, seed=c + co)
    before = CW.conv_wgrad_cuda.launches
    got = CW.conv_wgrad_cuda(x, dy)  # the mma.sync body (conv_wgrad follows the route)
    ref = CW.conv_wgrad_reference(x, dy)
    torch.cuda.synchronize()
    assert CW.conv_wgrad_cuda.launches == before + 1
    assert got.shape == (3, 3, c, co) and got.dtype == torch.float32
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    assert err <= WGRAD_TOL[dtype], err
    assert torch.equal(CW.conv_wgrad_cuda(x, dy), got)  # a fixed order of sums: the same bits
    xt = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)  # strided: copied
    assert torch.equal(CW.conv_wgrad_cuda(xt, dy), got)


def test_wgrad_kernel_matches_cudnns_conv_weight_gradient(dev):
    from eo_diffusion_torch.nn.primitives import Conv
    from eo_diffusion_torch.ops import conv_wgrad as CW

    conv = Conv(48, 40, dtype=torch.bfloat16).to(dev)
    conv.impl = "plain"  # cuDNN's weight gradient in .grad
    x = _wgrad_inputs(2, 24, 20, 48, 1, torch.bfloat16, seed=5)[0]
    saved = {}
    y = conv(x)
    y.register_hook(lambda g: saved.setdefault("dy", g.contiguous()))
    (y.float() * torch.randn_like(y.float())).sum().backward()
    got = CW.hwio_to_oihw(CW.conv_wgrad_cuda(x, saved["dy"]))
    want = conv.weight.grad  # cuDNN's, rounded to bf16 once
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= 1e-2, err


def test_wgrad_kernel_refuses_what_it_does_not_take(dev):
    from eo_diffusion_torch.ops import conv_wgrad as CW

    x, dy = _wgrad_inputs(1, 8, 8, 8, 8, torch.bfloat16, seed=0)
    before = CW.conv_wgrad_cuda.launches
    for bad in ((x.cpu(), dy.cpu()), (x.half(), dy.half()), (x, dy.float()),
                (x, dy[:, :4]), (x[0], dy[0])):
        with pytest.raises(ValueError):
            CW.conv_wgrad_cuda(*bad)
    CW.conv_wgrad_reference(x, dy)
    assert CW.conv_wgrad_cuda.launches == before


# the wgmma/TMA body: chip_smoke.py phase 8b's five shapes (WGRAD_SM90_CASES
# there), C 256 -> 256, C 1024 -> 512 at 32 x 32 and a ragged C 64 shape
WGRAD_SM90_SHAPES = [(8, 256, 256, 128, 128), (8, 256, 256, 256, 128), (8, 128, 128, 256, 256),
                     (8, 64, 64, 384, 384), (3, 20, 27, 40, 24), (2, 64, 64, 256, 256),
                     (8, 32, 32, 1024, 512), (1, 13, 29, 64, 72)]


@pytest.mark.parametrize("b,h,w,c,co", WGRAD_SM90_SHAPES)
def test_wgrad_sm90_matches_plain(dev, b, h, w, c, co):
    from eo_diffusion_torch.ops import conv_wgrad as CW

    x, dy = _wgrad_inputs(b, h, w, c, co, torch.bfloat16, seed=c + co + h)
    before = CW.conv_wgrad_sm90_cuda.launches
    got = CW.conv_wgrad(x, dy)  # the route's pick at every such shape
    ref = CW.conv_wgrad_reference(x, dy)
    torch.cuda.synchronize()
    assert CW.conv_wgrad_sm90_cuda.launches == before + 1
    assert got.shape == (3, 3, c, co) and got.dtype == torch.float32
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    assert err <= WGRAD_TOL[torch.bfloat16], err
    assert torch.equal(CW.conv_wgrad_sm90_cuda(x, dy), got)  # a fixed order: the same bits
    xt = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)  # strided: copied
    assert torch.equal(CW.conv_wgrad_sm90_cuda(xt, dy), got)


@pytest.mark.parametrize("b,h,w,c,co", [(2, 20, 37, 64, 64), (2, 16, 16, 128, 64),
                                        (1, 9, 33, 64, 24), (3, 24, 40, 72, 136)])
def test_wgrad_sm90_holds_each_tap_apart(dev, b, h, w, c, co):
    """dy a 1 at a few pixels (one output channel each): every tap's slice of
    dW is exactly the x pixel at its offset, or the padding's zero."""
    from eo_diffusion_torch.tools.prototype_wgrad_kernel import delta_check

    res = delta_check(b, h, w, c, co, torch.Generator(device="cuda").manual_seed(c))
    assert res["exact"] and res["deltas"] >= 9, res


def test_wgrad_sm90_refuses_what_it_does_not_take(dev):
    from eo_diffusion_torch.ops import conv_wgrad as CW

    x, dy = _wgrad_inputs(1, 8, 8, 16, 16, torch.bfloat16, seed=0)
    before = CW.conv_wgrad_sm90_cuda.launches
    for bad in ((x.cpu(), dy.cpu()), (x.float(), dy.float()), (x.half(), dy.half()),
                (x, dy.float()), (x[..., :6], dy), (x, dy[..., :3]), (x[0], dy[0])):
        with pytest.raises(ValueError):
            CW.conv_wgrad_sm90_cuda(*bad)
    with pytest.raises(ValueError):  # the route gives C 6 to cuDNN: the entry has no kernel
        CW.conv_wgrad(x[..., :6].contiguous(), dy)
    assert CW.conv_wgrad_sm90_cuda.launches == before


@pytest.mark.parametrize("c,co", [(48, 40), (64, 128), (6, 32)])
def test_routed_conv_gradients_match_cudnns(dev, c, co):
    """A bf16 3x3 Conv through the route (Conv3x3Fn: the kernel's dW, cuDNN's
    dx, an f32 db) against cuDNN's autograd: dW and db differ by the one
    bf16 rounding of cuDNN's (2^-9 relative) and the order of sums."""
    from eo_diffusion_torch.nn.primitives import Conv
    from eo_diffusion_torch.ops import conv_wgrad as CW

    conv = Conv(c, co, dtype=torch.bfloat16).to(dev)
    x = _wgrad_inputs(2, 24, 20, c, 1, torch.bfloat16, seed=c)[0].float()
    dy = torch.randn(2, 24, 20, co, device="cuda")
    grads, launched = {}, {}
    for impl in ("auto", "plain"):
        conv.impl = impl
        conv.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        before = CW.conv_wgrad_sm90_cuda.launches
        (conv(xi).float() * dy).sum().backward()
        launched[impl] = CW.conv_wgrad_sm90_cuda.launches - before
        grads[impl] = (conv.weight.grad, conv.bias.grad, xi.grad)
    assert launched == {"auto": int(c % 8 == 0), "plain": 0}
    for got, want in zip(grads["auto"], grads["plain"]):
        assert got.dtype == want.dtype and got.shape == want.shape
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= 1e-2, err


def test_unet_backward_with_checkpoint_through_the_kernels(dev):
    """use_checkpoint: every ResBlock recomputed in the backward, through the
    attention, GroupNorm and conv-wgrad Functions. The kernels are
    deterministic, so the gradients are those of the kernels without it, bit
    for bit; against the all-plain model without it they differ by the bf16
    roundings that part the kernels from the plain versions (rel L2 over all
    gradients; at this tiny width, 32 channels, about 1.2e-2, where the 256
    px model in chip_smoke.py reads under its 1e-2)."""
    from eo_diffusion_torch.ops import conv_wgrad as CW

    cfg = TU.UNetConfig(image_size=16, in_channels=3, model_channels=32, out_channels=3,
                        num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                        num_heads=2, dtype=torch.bfloat16)
    runs = {"checkpoint": (True, "auto"), "kernels": (False, "auto"), "plain": (False, "plain")}
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2, 16, 16, 3, generator=g, device="cuda")
    t = torch.tensor([3, 700], device="cuda")
    grads = {}
    for name, (ck, impl) in runs.items():
        model = randomize_parameters(TU.UNet(dataclasses.replace(cfg, use_checkpoint=ck)),
                                     seed=0).to(dev).set_impl(attn=impl, norm=impl, conv=impl)
        before = CW.conv_wgrad_sm90_cuda.launches
        model(x, t).float().square().mean().backward()
        grads[name] = [p.grad.float() for p in model.parameters()]
        assert (CW.conv_wgrad_sm90_cuda.launches > before) == (impl == "auto")
    assert all(torch.isfinite(a).all() for a in grads["checkpoint"])
    assert all(torch.equal(a, b) for a, b in zip(grads["checkpoint"], grads["kernels"]))
    num = sum((a - b).pow(2).sum().item() for a, b in zip(grads["checkpoint"], grads["plain"]))
    den = sum(b.pow(2).sum().item() for b in grads["plain"])
    assert (num / den) ** 0.5 <= 3e-2, (num / den) ** 0.5


# -- the attention-matmul probes ---------------------------------------------------


@pytest.mark.parametrize("layout,a_shape,b_shape", [
    ("nt", (48, 24), (40, 24)), ("nn", (48, 24), (24, 40)), ("tn", (24, 48), (24, 40)),
    ("nt", (512, 48), (2048, 48)), ("nn", (512, 2048), (2048, 96)),
    ("tn", (2048, 48), (2048, 512))])
def test_matmul_probe_kernel_matches_plain(dev, layout, a_shape, b_shape):
    from eo_diffusion_torch.ops import attn_probes as AP

    g = torch.Generator(device="cuda").manual_seed(len(layout) + a_shape[0])
    a = torch.randn(3, *a_shape, generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(3, *b_shape, generator=g, device="cuda").to(torch.bfloat16)
    before = AP.matmul_probe_cuda.launches
    got = AP.matmul_probe(a, b, layout)
    ref = AP.matmul_probe_reference(a, b, layout)
    torch.cuda.synchronize()
    assert AP.matmul_probe_cuda.launches == before + 1
    assert got.shape == ref.shape and got.dtype == torch.float32
    # exact bf16 products summed in f32 in another order
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_matmul_probe_kernel_refuses_what_it_does_not_take(dev):
    from eo_diffusion_torch.ops import attn_probes as AP

    a = torch.zeros(2, 16, 16, device="cuda", dtype=torch.bfloat16)
    before = AP.matmul_probe_cuda.launches
    for bad in ((a[:, :12], a[:, :12], "nt"), (a.float(), a.float(), "nt"),
                (a, a[:, :8], "nn"), (a, a, "xy"), (a.cpu(), a.cpu(), "nt")):
        with pytest.raises(ValueError):
            AP.matmul_probe_cuda(*bad)
    assert AP.matmul_probe_cuda.launches == before


@pytest.mark.parametrize("b,h,t,d,dtype", [
    (2, 2, 130, 48, torch.bfloat16), (1, 3, 64, 64, torch.bfloat16),
    (2, 2, 77, 128, torch.bfloat16), (1, 2, 1, 40, torch.bfloat16),
    (2, 3, 100, 40, torch.float32), (1, 2, 256, 64, torch.float32)])
def test_transposed_attention_kernel_matches_plain(dev, b, h, t, d, dtype):
    from eo_diffusion_torch.ops import attn_probes as AP

    g = torch.Generator(device="cuda").manual_seed(t + d)
    qkv5 = torch.randn(b, 3, h, t, d, generator=g, device="cuda")
    qkv5[:, :2] *= 2.0
    qkv5 = qkv5.to(dtype)
    before = AP.transposed_attention_cuda.launches
    got = AP.transposed_attention(qkv5)
    ref = AP.transposed_attention_reference(qkv5)
    torch.cuda.synchronize()
    assert AP.transposed_attention_cuda.launches == before + 1
    assert got.shape == (b, h, d, t) and got.dtype == dtype
    err = ((got.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_transposed_attention_every_head_dim_bf16(dev, d):
    from eo_diffusion_torch.ops import attn_probes as AP

    g = torch.Generator(device="cuda").manual_seed(d)
    qkv5 = (2.0 * torch.randn(2, 3, 2, 70, d, generator=g, device="cuda")).to(torch.bfloat16)
    got = AP.transposed_attention_cuda(qkv5)
    ref = AP.transposed_attention_reference(qkv5)
    err = ((got.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
    assert err <= TOL[torch.bfloat16], err


def test_transposed_attention_refuses_what_it_does_not_take(dev):
    from eo_diffusion_torch.ops import attn_probes as AP

    before = AP.transposed_attention_cuda.launches
    for shape, dtype in (((1, 3, 2, 16, 12), torch.bfloat16), ((1, 3, 2, 16, 136), torch.bfloat16),
                         ((1, 2, 2, 16, 16), torch.bfloat16), ((1, 3, 2, 16, 16), torch.half)):
        with pytest.raises(ValueError):
            AP.transposed_attention_cuda(torch.zeros(shape, device="cuda", dtype=dtype))
    with pytest.raises(ValueError):
        AP.transposed_attention_cuda(torch.zeros(1, 3, 2, 16, 16))
    assert AP.transposed_attention_cuda.launches == before


# -- the softmax-orientation probes, the hybrid and variant attentions -------------

# The attention probes against their plain versions (probe_packed_pv's
# attention_errors): at unit-normal inputs many keys share the weight and
# |plain| sits far below 1, so each is held elementwise to TOL of max(rms,
# |plain|), which one dropped K/V stage breaks, and by its relative L2
# difference to TOL_ATTN_L2, which a fault that scales every output (l off by
# 1 %: 1e-2) breaks; bf16: one output ulp where two f32 values straddle a
# rounding, and p rounded at another running max
TOL_ATTN_L2 = 5e-3


def _assert_attention_close(got, ref, what=""):
    from eo_diffusion_torch.tools.probe_packed_pv import attention_errors

    e = attention_errors(got, ref)
    assert e["max_rms_scaled_err"] <= TOL[torch.bfloat16], (what, e)
    assert e["rel_l2_err"] <= TOL_ATTN_L2, (what, e)


@pytest.mark.parametrize("shape", [(3, 37, 100), (2, 64, 256), (1, 5, 3), (4, 512, 2048)])
@pytest.mark.parametrize("axis", [1, 0])
def test_softmax_stats_kernel_matches_plain(dev, shape, axis):
    from eo_diffusion_torch.ops import softmax_probes as SP

    g = torch.Generator(device="cuda").manual_seed(sum(shape) + axis)
    s = 3.0 * torch.randn(*shape, generator=g, device="cuda")
    before = SP.softmax_stats_cuda.launches
    got = SP.softmax_stats(s, axis)
    ref = SP.softmax_stats_reference(s, axis)
    torch.cuda.synchronize()
    assert SP.softmax_stats_cuda.launches == before + 1
    assert got.shape == ref.shape and got.dtype == torch.float32
    # the order of f32 sums
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("shape", [(3, 37, 100), (2, 64, 256), (1, 1, 33), (4, 512, 2048)])
def test_transpose_kernel_is_bit_exact(dev, shape):
    from eo_diffusion_torch.ops import softmax_probes as SP

    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    p = torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
    before = SP.transpose_accumulate_cuda.launches
    got = SP.transpose_accumulate(p)
    assert SP.transpose_accumulate_cuda.launches == before + 1
    assert torch.equal(got, SP.transpose_accumulate_reference(p))


def test_softmax_probe_kernels_refuse_what_they_do_not_take(dev):
    from eo_diffusion_torch.ops import softmax_probes as SP

    s = torch.zeros(2, 8, 8, device="cuda")
    before = (SP.softmax_stats_cuda.launches, SP.transpose_accumulate_cuda.launches)
    for bad in ((s.bfloat16(), 1), (s, 2), (s[0], 1), (s.cpu(), 1)):
        with pytest.raises(ValueError):
            SP.softmax_stats_cuda(*bad)
    for bad in (s, s[0].bfloat16(), s.cpu().bfloat16()):
        with pytest.raises(ValueError):
            SP.transpose_accumulate_cuda(bad)
    assert (SP.softmax_stats_cuda.launches, SP.transpose_accumulate_cuda.launches) == before


@pytest.mark.parametrize("b,h,t,d,bk", [
    (2, 2, 130, 48, 64), (1, 3, 64, 64, 128), (2, 2, 77, 128, 64), (1, 2, 1, 40, 64),
    (2, 3, 1000, 40, 128), (1, 2, 300, 64, 256), (1, 2, 300, 96, 64)])
@pytest.mark.parametrize("variant", ["hybrid", "hybrid2"])
def test_hybrid_attention_kernel_matches_plain(dev, b, h, t, d, bk, variant):
    from eo_diffusion_torch.ops import attn_probes as AP

    g = torch.Generator(device="cuda").manual_seed(t + d)
    qkv5 = torch.randn(b, 3, h, t, d, generator=g, device="cuda")
    qkv5[:, :2] *= 2.0
    qkv5 = qkv5.to(torch.bfloat16)
    before = AP.hybrid_attention_cuda.launches
    got = AP.hybrid_attention(qkv5, variant, bk)
    ref = AP.transposed_attention_reference(qkv5)
    torch.cuda.synchronize()
    assert AP.hybrid_attention_cuda.launches == before + 1
    assert got.shape == (b, h, d, t) and got.dtype == torch.bfloat16
    _assert_attention_close(got, ref)


@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_hybrid_attention_every_head_dim(dev, d):
    from eo_diffusion_torch.ops import attn_probes as AP

    g = torch.Generator(device="cuda").manual_seed(d)
    qkv5 = (2.0 * torch.randn(2, 3, 2, 70, d, generator=g, device="cuda")).to(torch.bfloat16)
    ref = AP.transposed_attention_reference(qkv5)
    for variant in AP.HYBRIDS:
        _assert_attention_close(AP.hybrid_attention_cuda(qkv5, variant), ref, variant)


def test_hybrid_attention_refuses_what_it_does_not_take(dev):
    from eo_diffusion_torch.ops import attn_probes as AP

    before = AP.hybrid_attention_cuda.launches
    ok = torch.zeros(1, 3, 2, 16, 16, device="cuda", dtype=torch.bfloat16)
    wide = torch.zeros(1, 3, 2, 16, 96, device="cuda", dtype=torch.bfloat16)
    for args in ((ok.float(),), (ok[:, :2],), (ok, "hybrid3"), (ok, "hybrid", 96),
                 (wide, "hybrid", 128),
                 (torch.zeros(1, 3, 2, 16, 12, device="cuda", dtype=torch.bfloat16),),
                 (ok.cpu(),)):
        with pytest.raises(ValueError):
            AP.hybrid_attention_cuda(*args)
    assert AP.hybrid_attention_cuda.launches == before


@pytest.mark.parametrize("b,t,h,d", [(2, 130, 2, 48), (1, 1000, 3, 40), (2, 64, 2, 64),
                                     (1, 1, 2, 16), (1, 300, 2, 32)])
@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_attention_variant_kernel_matches_plain(dev, b, t, h, d, variant):
    from eo_diffusion_torch.ops import attn_variants as AV

    g = torch.Generator(device="cuda").manual_seed(t + d)
    q, k, v = (torch.randn(b, t, h, d, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    ref = AV.attention_variant_reference(q, k, v, variant)
    for warps, bk in AV.TILES[variant]:
        before = AV.attention_variant_cuda.launches
        got = AV.attention_variant(q, k, v, variant, warps, bk)
        torch.cuda.synchronize()
        assert AV.attention_variant_cuda.launches == before + 1
        assert got.shape == q.shape and got.dtype == torch.bfloat16
        _assert_attention_close(got, ref, (warps, bk))


def test_attention_variant_b_is_k1s_function(dev):
    """B at K1's tile against the port's attention kernel on the same tensors."""
    from eo_diffusion_torch.ops import attn_variants as AV

    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(2, 257, 3, 48, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    _assert_attention_close(AV.attention_variant_cuda(q, k, v, "B"),
                            A.flash_attention_cuda(q, k, v))


def test_attention_variant_refuses_what_it_does_not_take(dev):
    from eo_diffusion_torch.ops import attn_variants as AV

    ok = torch.zeros(1, 16, 2, 16, device="cuda", dtype=torch.bfloat16)
    big = torch.zeros(1, 16, 2, 80, device="cuda", dtype=torch.bfloat16)
    before = AV.attention_variant_cuda.launches
    for args in ((ok.float(), ok.float(), ok.float(), "B"), (big, big, big, "B"),
                 (ok, ok, ok, "A", 16), (ok, ok, ok, "A", 4, 128), (ok, ok, ok, "B", 4, 96),
                 (ok, ok, ok, "E"),
                 (ok.cpu(), ok.cpu(), ok.cpu(), "B")):
        with pytest.raises(ValueError):
            AV.attention_variant_cuda(*args)
    assert AV.attention_variant_cuda.launches == before


@pytest.mark.parametrize("b,t,h,d", [(2, 4096, 8, 48), (2, 1000, 3, 40), (1, 77, 2, 64)])
def test_fused_layout_route_goes_through_k1(dev, b, t, h, d):
    from eo_diffusion_torch.ops import attn_variants as AV

    g = torch.Generator(device="cuda").manual_seed(t)
    qkv = torch.randn(b, t, 3, h, d, generator=g, device="cuda")
    qkv[:, :, :2] *= 2.0
    qkv = qkv.to(torch.bfloat16)
    before = A.qkv_attention_cuda.launches
    got = AV.fused_layout_attention(qkv)
    ref = AV.fused_layout_attention_reference(qkv)
    torch.cuda.synchronize()
    assert A.qkv_attention_cuda.launches == before + 1
    assert got.shape == (b, t, h, d) and got.dtype == torch.bfloat16
    _assert_attention_close(got, ref)


# ---------------------------------------------------------------------------
# the data feed's device side (no kernel of its own: copies and torch ops)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 2, 4])
def test_device_prefetch_yields_the_loader_batches_bit_for_bit(dev, size):
    """Pinned host memory, a side stream, the consumer waiting on the copy:
    every batch reaches the card unchanged, in order, while the consuming
    stream keeps busy with work that reuses the freed memory."""
    import numpy as np

    from eo_diffusion_torch.data.datasets import SyntheticEO
    from eo_diffusion_torch.data.factories import _FLIPS
    from eo_diffusion_torch.data.loader import DataLoader, device_prefetch

    ds = SyntheticEO(size=64, length=40, with_cond_image=True)
    want = list(DataLoader(ds, 4, transforms=_FLIPS, seed=3))
    got = []
    for batch in device_prefetch(DataLoader(ds, 4, transforms=_FLIPS, seed=3), dev, size=size):
        assert all(v.device.type == "cuda" for v in batch.values())
        torch.cuda._sleep(1_000_000)  # the consumer is busy when the next copies land
        scratch = [torch.empty_like(v).fill_(-1) for v in batch.values()]
        got.append({k: v.cpu().numpy() for k, v in batch.items()})
        del scratch
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_device_data_cache_gathers_on_the_card(dev):
    import numpy as np

    from eo_diffusion_torch.data.device_cache import DeviceDataCache, gather_core

    rng = np.random.default_rng(0)
    data = {"image": rng.normal(size=(12, 32, 32, 3)).astype(np.float32),
            "mask": (rng.uniform(size=(12, 32, 32)) > 0.5).astype(np.float32),
            "label": np.arange(12, dtype=np.int32)}
    cache = DeviceDataCache(data, dev)
    assert all(v.device.type == "cuda" for v in cache.tensors.values())
    idx = np.array([3, 0, 11, 3, 7, 5])
    do_h = np.array([True, False, True, False, True, False])
    do_v = np.array([False, False, True, True, True, False])
    out = gather_core(cache.tensors, torch.from_numpy(idx).to(dev),
                      torch.from_numpy(do_h).to(dev), torch.from_numpy(do_v).to(dev))
    for k, v in data.items():
        want = v[idx].copy()
        for i in range(len(idx)):
            if want.ndim >= 3 and do_h[i]:
                want[i] = want[i][:, ::-1]
            if want.ndim >= 3 and do_v[i]:
                want[i] = want[i][::-1]
        np.testing.assert_array_equal(out[k].cpu().numpy(), want)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = cache.sample_batch(g, 8, compute_dtype=torch.bfloat16)
    assert batch["image"].shape == (8, 32, 32, 3) and batch["image"].dtype == torch.bfloat16
    assert batch["label"].dtype == torch.int32


# -- the latent stack: the first stage's GroupNorm sites and a latent DiT step ---

# (N, HW, C): latent256-cr's six norm sites (three shapes, each in the encoder
# and the decoder) at N 2, float32 with SiLU and no FiLM, as the first stage
# runs them
@pytest.mark.parametrize("hw,c", [(65536, 128), (16384, 256), (4096, 512)])
def test_group_norm_f32_at_the_autoencoder_sites(dev, hw, c):
    _check_gn(*_gn_inputs(2, hw, c, torch.float32, seed=hw + c), 32, "silu")


def _launch_counts():
    from eo_diffusion_torch.ops import conv_wgrad as CW

    return {"gn_fwd": G.group_norm_fwd_cuda.launches, "gn_bwd": G.group_norm_bwd_cuda.launches,
            "attn_fwd": A.qkv_attention_cuda.launches,
            "attn_bwd": A.qkv_attention_bwd_cuda.launches,
            "wgrad": CW.conv_wgrad_cuda.launches + CW.conv_wgrad_sm90_cuda.launches}


def _delta(before):
    return {k: v - before[k] for k, v in _launch_counts().items()}


def test_autoencoder_on_the_card_matches_plain(dev):
    """A float32 first stage (base 32, f4) at 64 px: encode -> decode and one
    ``ae_loss`` backward with the GroupNorm kernels against the all-plain
    model, same weights. One kernel launch a norm each way (3 + 3), no
    attention, no weight-gradient kernel (f32 convs take cuDNN's)."""
    from eo_diffusion_torch.models.autoencoder import AutoencoderConfig, ConvAutoencoder
    from eo_diffusion_torch.train.ae_trainer import ae_loss

    cfg = AutoencoderConfig(in_channels=3, latent_channels=4, base_channels=32, num_down=2)
    model = randomize_parameters(ConvAutoencoder(cfg), seed=2).to(dev)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand(2, 64, 64, 3, generator=g, device="cuda") * 2 - 1
    outs, losses, grads, launched = {}, {}, {}, {}
    for impl in ("auto", "plain"):
        model.set_impl(norm=impl, conv=impl).zero_grad(set_to_none=True)
        before = _launch_counts()
        with torch.no_grad():
            outs[impl] = model(x)
        loss, _ = ae_loss(model, x)
        loss.backward()
        torch.cuda.synchronize()
        launched[impl] = _delta(before)
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert launched["auto"] == {"gn_fwd": 12, "gn_bwd": 6, "attn_fwd": 0, "attn_bwd": 0,
                                "wgrad": 0}, launched["auto"]
    assert not any(launched["plain"].values()), launched["plain"]
    assert outs["auto"].shape == x.shape and outs["auto"].dtype == torch.float32
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    assert rel(outs["auto"], outs["plain"]) <= 1e-5
    assert abs(losses["auto"] - losses["plain"]) <= 1e-5 * abs(losses["plain"])
    num = sum((grads["auto"][n] - v).pow(2).sum().item() for n, v in grads["plain"].items())
    den = sum(v.pow(2).sum().item() for v in grads["plain"].values())
    assert (num / den) ** 0.5 <= 1e-4


def test_latent_dit_step_runs_the_first_stage_forward_only(dev):
    """One trainer step of a latent flow DiT (T 256, D 64, bf16) with the
    cloudy view encoded: K1 (with the lse) and K4 once a block, the first
    stage's three GroupNorms forward for x0 and three for the cond, and no
    GroupNorm backward, no weight-gradient kernel, no gradient on the first
    stage."""
    from eo_diffusion_torch.diffusion.flow import FlowMatching
    from eo_diffusion_torch.diffusion.latent import LatentDiffusion
    from eo_diffusion_torch.models import dit as TD
    from eo_diffusion_torch.models.autoencoder import AutoencoderConfig, ConvAutoencoder
    from eo_diffusion_torch.train.ae_trainer import make_codec
    from eo_diffusion_torch.train.trainer import Trainer, TrainerConfig

    ae = randomize_parameters(ConvAutoencoder(AutoencoderConfig(base_channels=32)), 5).to(dev)
    enc, dec = make_codec(ae)
    ld = LatentDiffusion(FlowMatching.create(image_size=16, in_channels=4, cond_type="concat"),
                         enc, dec, scale_factor=0.8, cond_via_encoder=True)
    cfg = TD.DiTConfig(image_size=16, in_channels=8, out_channels=4, patch_size=1,
                       hidden_size=256, depth=3, num_heads=4, dtype=torch.bfloat16)
    trainer = Trainer(TrainerConfig(cond_type="concat", preview_sampler="flow", epochs=1,
                                    preview_steps=2),
                      TD.DiT(cfg), ld, steps_per_epoch=1, device=dev)
    assert trainer.float_t  # a latent flow is a flow: its loss takes float times
    state = trainer.init()
    g = torch.Generator(device="cuda").manual_seed(6)
    batch = {"image": torch.rand(4, 64, 64, 3, generator=g, device="cuda") * 2 - 1,
             "cond": torch.rand(4, 64, 64, 3, generator=g, device="cuda") * 2 - 1}
    before = _launch_counts()
    state, metrics = trainer.step(state, batch)
    torch.cuda.synchronize()
    assert _delta(before) == {"gn_fwd": 6, "gn_bwd": 0, "attn_fwd": 3, "attn_bwd": 3,
                              "wgrad": 0}
    assert torch.isfinite(metrics["loss"]) and all(p.grad is None for p in ae.parameters())
    before = _launch_counts()
    x = trainer.sample(state, seed=1, n=2, cond=batch["cond"][:2])
    assert x.shape == (2, 64, 64, 3) and x.dtype == torch.float32
    assert _delta(before)["gn_fwd"] == 6  # cond encode + the decode


# The sampling CLI's guidance on the card: classifier-free guidance doubles
# the 256 px batch (B16 at the clouds UNet's two attention shapes, N16 at its
# GroupNorm level shapes); PAG's perturbed call and DeepCache's partial calls
# launch what the counters below say.
@pytest.mark.parametrize("t,d", [(4096, 48), (1024, 64)])
def test_cfg_doubled_attention_shapes_match_plain(dev, t, d):
    _check(_qkv(16, t, 8, d, torch.bfloat16, seed=t + d), 8, new_order=False)


@pytest.mark.parametrize("hw,c,act", [(65536, 128, "silu"), (16384, 256, "silu"),
                                      (4096, 384, "none"), (1024, 512, "silu")])
def test_cfg_doubled_group_norm_shapes_match_plain(dev, hw, c, act):
    _check_gn(*_gn_inputs(16, hw, c, torch.bfloat16, seed=hw + c), 32, act)


@torch.no_grad()
def test_pag_perturbed_call_launches_no_attention_kernel(dev):
    """A bf16 UNet under ``identity_attention``: no attention launch, one
    identity hit an attention block, every GroupNorm still on its kernel;
    the guided prediction is finite."""
    from eo_diffusion_torch.diffusion.pag import pag_model_fn

    cfg = TU.UNetConfig(image_size=32, in_channels=3, model_channels=32, out_channels=3,
                        num_res_blocks=1, attention_resolutions=(2, 4), channel_mult=(1, 2, 2),
                        num_heads=2, dtype=torch.bfloat16)
    model = randomize_parameters(TU.UNet(cfg), seed=3).to(dev).eval()
    x = torch.randn(2, 32, 32, 3, device=dev)
    t = torch.tensor([5, 500], device=dev)
    attn, norms = TU.build_unet_plan(cfg).sites()
    before, hits = _launch_counts(), A.identity_attention_hits()
    with A.identity_attention():
        out = model(x, t)
    assert _delta(before) == {"gn_fwd": norms, "gn_bwd": 0, "attn_fwd": 0, "attn_bwd": 0,
                              "wgrad": 0}
    assert A.identity_attention_hits() - hits == attn > 0 and torch.isfinite(out).all()
    before = _launch_counts()
    guided = pag_model_fn(lambda x, t, c, y: model(x, t), 2.0)(x, t, None, None)
    assert _delta(before)["attn_fwd"] == attn and _delta(before)["gn_fwd"] == 2 * norms
    assert torch.isfinite(guided).all()


@torch.no_grad()
def test_deepcache_partial_call_on_the_card(dev):
    """The partial forward on a fresh cache against the full forward (the
    kernels' bf16 forward limit of chip_smoke.py phase 4), launching only the
    shallow blocks' GroupNorms and no attention."""
    cfg = TU.UNetConfig(image_size=32, in_channels=3, model_channels=32, out_channels=3,
                        num_res_blocks=2, attention_resolutions=(2, 4), channel_mult=(1, 2, 2),
                        num_heads=2, dtype=torch.bfloat16)
    model = randomize_parameters(TU.UNet(cfg), seed=4).to(dev).eval()
    x = torch.randn(2, 32, 32, 3, device=dev)
    t = torch.tensor([5, 500], device=dev)
    full, deep = model(x, t, return_deep=True)
    before = _launch_counts()
    part = model(x, t, deep_cache=deep)
    _, shallow_norms = TU.build_unet_plan(cfg).sites(shallow_depth=1 + cfg.num_res_blocks)
    assert _delta(before) == {"gn_fwd": shallow_norms, "gn_bwd": 0, "attn_fwd": 0,
                              "attn_bwd": 0, "wgrad": 0}
    rel = ((part.float() - full.float()).norm() / full.float().norm()).item()
    assert torch.isfinite(part).all() and rel <= 3e-2, rel


def _counts():
    from eo_diffusion_torch.ops import group_norm as G

    return (A.qkv_attention_cuda.launches, A.qkv_attention_bwd_cuda.launches,
            G.group_norm_fwd_cuda.launches, G.group_norm_bwd_cuda.launches)


def test_classifier_input_gradient_through_the_kernels(dev):
    """The EncoderUNet's input gradient inside ``torch.inference_mode()``, as
    the guided samplers take it: K1 with the lse, K4 and K5 both ways (two
    attention blocks, thirteen norms at this width), against the all-plain
    classifier, and no gradient on the frozen weights."""
    from eo_diffusion_torch.diffusion.classifier_guidance import log_prob_grad
    from eo_diffusion_torch.models.encoder_unet import EncoderUNet, EncoderUNetConfig

    cfg = EncoderUNetConfig(image_size=32, in_channels=3, model_channels=32, num_classes=4,
                            num_res_blocks=1, attention_resolutions=(2, 4),
                            channel_mult=(1, 2, 2), num_heads=2)
    model = randomize_parameters(EncoderUNet(cfg), seed=3).to(dev).eval().requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(4, 32, 32, 3, generator=g, device="cuda")
    t, y = torch.tensor([5, 300, 600, 999], device="cuda"), torch.tensor([0, 1, 2, 3],
                                                                           device="cuda")
    before = _counts()
    with torch.inference_mode():
        got = log_prob_grad(model, x, t, y)
    launched = tuple(b - a for a, b in zip(before, _counts()))
    assert launched == (2, 2, 13, 13), launched
    model.set_impl(attn="plain", norm="plain")
    with torch.inference_mode():
        want = log_prob_grad(model, x, t, y)
    rel = ((got - want).norm() / want.norm()).item()
    assert bool(torch.isfinite(got).all()) and rel <= 1e-3, rel
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("task", ["sr4", "inpaint", "colorize"])
def test_ddnm_range_consistency_on_the_card(dev, task):
    """DDNM through the UNet's kernels: A(x) = y to float32 rounding after the
    final projection."""
    from eo_diffusion_torch.diffusion import inverse as INV
    from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion

    cfg = TU.UNetConfig(image_size=32, in_channels=3, model_channels=32, out_channels=3,
                        num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                        num_heads=2, dtype=torch.bfloat16)
    model = randomize_parameters(TU.UNet(cfg), seed=5).to(dev).eval()
    g = torch.Generator(device="cuda").manual_seed(6)
    gt = torch.rand(2, 32, 32, 3, generator=g, device="cuda") * 2 - 1
    op = {"sr4": INV.sr_operator(4), "colorize": INV.gray_operator(3),
          "inpaint": INV.inpaint_operator(
              (torch.rand(2, 32, 32, 1, generator=g, device="cuda") > 0.5).float())}[task]
    y = op.forward(gt)
    before = A.qkv_attention_cuda.launches
    with torch.inference_mode():
        x = INV.ddnm_sample(GaussianDiffusion.create(timesteps=100, image_size=32),
                            lambda xx, tt, c, yy: model(xx, tt, cond=c, y=yy), y, op,
                            num_steps=10, generator=g).x
    assert A.qkv_attention_cuda.launches > before
    assert bool(torch.isfinite(x).all())
    assert ((op.forward(x) - y).norm() / y.norm()).item() <= 1e-5


@pytest.mark.parametrize("t,h,d,dtype", [(64, 1, 1024, torch.bfloat16),   # inria64's middle
                                         (64, 1, 512, torch.bfloat16),    # eurosat64's
                                         (77, 2, 264, torch.bfloat16),
                                         (130, 1, 136, torch.float32),
                                         (1024, 1, 520, torch.float32)])
def test_wide_head_dims_launch_the_wide_kernels(dev, t, h, d, dtype):
    """Head dims above the attention bodies' take the kernels of
    attention_wide.cu through the auto path, forward (with the lse) and
    backward, against the plain versions on the same inputs; a ragged T and
    the split_qkv views of both head orders."""
    for new_order in (False, True):
        qkv = _qkv(2, t, h, d, dtype, seed=t + d).requires_grad_()
        g = torch.Generator(device="cuda").manual_seed(d)
        dout = torch.randn(2, t, h * d, generator=g, device="cuda").to(dtype)
        before = (A.wide_attention_cuda.launches, A.wide_attention_bwd_cuda.launches,
                  A.flash_attention_cuda.launches, A.flash_attention_bwd_cuda.launches)
        out = A.attention_from_qkv(qkv, h, new_order)
        (dqkv,) = torch.autograd.grad(out, qkv, dout)
        after = (A.wide_attention_cuda.launches, A.wide_attention_bwd_cuda.launches,
                 A.flash_attention_cuda.launches, A.flash_attention_bwd_cuda.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0, 0)
        q, k, v = A.split_qkv(qkv.detach(), h, new_order)
        ref, ref_lse = A.reference_attention(q, k, v, return_lse=True)
        _, lse = A.wide_attention_cuda(q, k, v, return_lse=True)
        assert (lse - ref_lse).abs().max().item() <= 1e-3
        assert _scaled_err(out.reshape(ref.shape), ref, 1.0) <= TOL[dtype]
        grads = A.reference_attention_bwd(q, k, v, ref, ref_lse, dout.reshape(ref.shape))
        want = A.stack_qkv(*grads, new_order=new_order)
        rms = want.float().pow(2).mean().sqrt().item()
        err = ((dqkv.float() - want.float()).abs() / want.float().abs().clamp(min=rms)).max()
        assert err.item() <= TOL_BWD[dtype], err.item()
