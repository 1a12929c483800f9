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
    with pytest.raises(ValueError):  # head dim 136 > 128
        A.attention_from_qkv(_qkv(1, 16, 1, 136, torch.bfloat16, seed=1), 1)
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
