"""The port's CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc`` and skip without
them. Run them on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

The shapes here are small and cover the dispatch cases (every head dim the
kernel takes, both head orders, ragged T, strided inputs, float32);
``chip_smoke.py`` holds the kernel at the main path's full shapes.
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
