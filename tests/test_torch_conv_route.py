"""The conv weight gradient's route into the UNet's backward, on the CPU:
``wgrad_route`` over the stride-1 3x3 sites of a 256 and a 512 px training
step, the split planner of the ``wgmma`` body, the ``Conv3x3Fn`` autograd
Function with the plain weight gradient against autograd through
``F.conv2d``, the ``UNetConfig.use_checkpoint`` repair, and the field
order of ``UNetConfig``, ``TrainerConfig`` and ``Preset`` against JAX's."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from eo_diffusion_torch.models import unet as TU
from eo_diffusion_torch.nn.primitives import Conv
from eo_diffusion_torch.ops import conv_wgrad as CW
from eo_diffusion_torch.tools import prototype_wgrad_kernel as tool
from eo_diffusion_torch.weights import randomize_parameters
from eo_diffusion_tpu.models import unet as JU
from torch_parity import one_torch_thread  # noqa: F401

# ((B, H, W, C, Co), sites) of the stride-1 3x3 convs of one sen12mscr256
# training step: 49 sites at 256 px batch 8, the same 49 at 512 px batch 4
SITES = {
    (256, 8): [((8, 256, 256, 6, 128), 1), ((8, 256, 256, 128, 128), 7),
               ((8, 256, 256, 256, 128), 2), ((8, 256, 256, 384, 128), 1),
               ((8, 256, 256, 256, 256), 1), ((8, 256, 256, 128, 3), 1),
               ((8, 128, 128, 128, 256), 1), ((8, 128, 128, 256, 256), 6),
               ((8, 128, 128, 384, 256), 1), ((8, 128, 128, 512, 256), 1),
               ((8, 128, 128, 640, 256), 1), ((8, 128, 128, 384, 384), 1),
               ((8, 64, 64, 256, 384), 1), ((8, 64, 64, 384, 384), 6),
               ((8, 64, 64, 512, 512), 1), ((8, 64, 64, 640, 384), 1),
               ((8, 64, 64, 768, 384), 1), ((8, 64, 64, 896, 384), 1),
               ((8, 32, 32, 384, 512), 1), ((8, 32, 32, 512, 512), 10),
               ((8, 32, 32, 896, 512), 1), ((8, 32, 32, 1024, 512), 2)],
}
SITES[(512, 4)] = [((4, 2 * h, 2 * w, c, co), n) for (_, h, w, c, co), n in SITES[(256, 8)]]
CASES = [(key, shape) for key, sites in SITES.items() for shape, _ in sites]


# the sites where the card's sweep timed cuDNN's weight gradient below the
# wgmma body's (the input and output convs aside, whose C 6 and Co 3 the body
# does not take): they stay on cuDNN, every other site takes the body
CUDNN_SITES = {(8, 32, 32, 384, 512), (8, 32, 32, 896, 512), (8, 32, 32, 512, 512),
               (8, 64, 64, 256, 384), (4, 64, 64, 384, 512), (4, 64, 64, 896, 512)}


def _want(shape):
    b, h, w, c, co = shape
    return "cudnn" if c % 8 or co % 8 or shape in CUDNN_SITES else "sm90"


def test_the_table_is_the_unets_sites():
    """The 256 px table is what hooks on a forward collect (on the meta
    device: shapes only, no arithmetic); the 512 px one doubles H and W."""
    got = tool.site_shapes(256, 8)
    counts = {}
    for _, *shape in got:
        counts[tuple(shape)] = counts.get(tuple(shape), 0) + 1
    assert counts == dict(SITES[(256, 8)]) and len(got) == 49


@pytest.mark.parametrize("key,shape", CASES, ids=[f"{k[0]}px-" + "x".join(map(str, s))
                                                  for k, s in CASES])
def test_every_site_takes_the_route_the_sweep_chose(key, shape):
    route = CW.wgrad_route(*shape, torch.bfloat16)
    assert route == _want(shape)
    assert CW.wgrad_route(*shape, torch.float32) == "cudnn"
    if route == "sm90":  # a launch the wgmma body takes: splits within its tiles
        b, h, w, c, co = shape
        s = CW.splits_sm90(b, h, w, c, co, 132)
        assert 1 <= s <= b * -(-h // CW.TILE_H) * -(-w // CW.TILE_W)


@pytest.mark.parametrize("shape,dtype,want", [
    ((8, 256, 256, 6, 128), torch.bfloat16, "cudnn"),    # the input conv: C 6
    ((8, 256, 256, 128, 3), torch.bfloat16, "cudnn"),    # the output conv: Co 3
    ((3, 20, 27, 40, 24), torch.bfloat16, "sm90"),       # ragged pixels, C and Co / 8
    ((4, 32, 32, 384, 512), torch.bfloat16, "sm90"),     # a level-3 shape at a batch not swept
    ((2, 20, 24, 12, 24), torch.bfloat16, "cudnn"),      # C not a multiple of 8
    ((8, 256, 256, 128, 128), torch.float32, "cudnn"),   # f32: the FMA kernel is a check
    ((8, 256, 256, 128, 128), torch.float16, "cudnn"),
])
def test_the_route_of_shapes_off_the_unets(shape, dtype, want):
    assert CW.wgrad_route(*shape, dtype) == want


@pytest.mark.parametrize("shape,sms,want", [
    ((8, 256, 256, 128, 128), 132, 33),  # 4 tile pairs: one block an SM
    ((8, 128, 128, 128, 256), 132, 16),  # 8 pairs: one wave of 128, not two of 264
    ((8, 32, 32, 1024, 512), 132, 1),    # 128 pairs: one wave, no workspace
    ((8, 32, 32, 512, 512), 132, 2),     # 64 pairs: the workspace beats half the card idle
    ((8, 64, 64, 384, 384), 132, 7),     # 36 pairs: 252 blocks in two waves
    ((1, 8, 16, 64, 64), 132, 1),        # one dy tile
])
def test_splits_of_the_wgmma_body(shape, sms, want):
    assert CW.splits_sm90(*shape, sms) == want


@pytest.mark.parametrize("b,h,w,c,co", [(2, 7, 9, 5, 6), (1, 10, 8, 6, 3)])
def test_conv3x3_function_matches_autograd_on_cpu(b, h, w, c, co):
    """Conv3x3Fn with the plain weight gradient: dx, dW and db against
    autograd through F.conv2d, f32; both sum the same products in another
    order (relative to the largest value, 1e-5)."""
    g = torch.Generator().manual_seed(b * 100 + c)
    x0 = torch.randn(b, h, w, c, generator=g)
    w0 = torch.randn(co, c, 3, 3, generator=g) / 3
    b0 = torch.randn(co, generator=g)
    dy = torch.randn(b, h, w, co, generator=g)
    got = [t.clone().requires_grad_() for t in (x0, w0, b0)]
    want = [t.clone().requires_grad_() for t in (x0, w0, b0)]
    y = CW.Conv3x3Fn.apply(got[0], got[1], got[2], torch.float32)
    y_ref = F.conv2d(want[0].permute(0, 3, 1, 2), want[1], want[2], 1, 1).permute(0, 2, 3, 1)
    assert torch.equal(y, y_ref)
    y.backward(dy)
    y_ref.backward(dy)
    for a, r in zip(got, want):
        rel = ((a.grad - r.grad).abs().max() / r.grad.abs().max()).item()
        assert a.grad.shape == r.grad.shape and a.grad.dtype == torch.float32 and rel <= 1e-5


def test_a_cpu_conv_keeps_plain_autograd():
    conv = Conv(8, 8, dtype=torch.float32)
    y = conv(torch.randn(1, 4, 4, 8))
    assert "Conv3x3Fn" not in type(y.grad_fn).__name__
    with pytest.raises(ValueError):
        CW.conv3x3(torch.randn(1, 4, 4, 8), conv.weight, conv.bias, torch.float32, impl="fast")


# the JAX Preset fields whose port waits on ROADMAP queue 1, items 13-14
# (the MoE DiT, the super-resolution stage): the one gap allowed in the
# field-order check
PRESET_FIELDS_LATER = ("num_experts", "moe_top_k", "moe_every", "sr_factor")
CONFIG_PAIRS = {
    "UNetConfig": ("eo_diffusion_tpu.models.unet", "eo_diffusion_torch.models.unet",
                   "UNetConfig", ()),
    "TrainerConfig": ("eo_diffusion_tpu.train.trainer", "eo_diffusion_torch.train.trainer",
                      "TrainerConfig", ()),
    "Preset": ("eo_diffusion_tpu.cli.presets", "eo_diffusion_torch.cli.presets", "Preset",
               PRESET_FIELDS_LATER),
}


@pytest.mark.parametrize("name", sorted(CONFIG_PAIRS))
def test_unet_config_fields_sit_where_jax_has_them(name):
    """Every field of the port's UNetConfig, TrainerConfig and Preset sits
    at the index the JAX package's has it, so a config passed by position
    means the same in both; the JAX-only Preset fields of items 13-14 are
    left out of the JAX list, and nothing else may differ."""
    import importlib

    jmod, tmod, cls, later = CONFIG_PAIRS[name]
    names = lambda mod: [f.name for f in dataclasses.fields(
        getattr(importlib.import_module(mod), cls))]
    jax_fields = [f for f in names(jmod) if f not in later]
    assert names(tmod) == jax_fields
    if name == "UNetConfig":
        assert TU.UNetConfig(8, 3, 16, 3, 1, (), 4, 0.0, (1,), True, None, True).use_checkpoint


def test_use_checkpoint_gives_the_same_output_and_gradients():
    """Each ResBlock recomputed in the backward (with dropout, whose mask the
    restored RNG state draws again) gives the bits of the plain backward."""
    kw = dict(image_size=8, in_channels=3, model_channels=16, out_channels=3,
              num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
              num_heads=2, dropout=0.3)
    models = {ck: TU.UNet(TU.UNetConfig(**kw, use_checkpoint=ck)).train() for ck in (False, True)}
    randomize_parameters(models[False], seed=3)  # no zero-initialised layer left
    models[True].load_state_dict(models[False].state_dict())
    g = torch.Generator().manual_seed(0)
    x, t = torch.randn(2, 8, 8, 3, generator=g), torch.tensor([3, 40])
    out, grads = {}, {}
    for ck, model in models.items():
        torch.manual_seed(5)
        out[ck] = model(x, t)
        out[ck].square().sum().backward()
        grads[ck] = [p.grad for p in model.parameters()]
    assert torch.equal(out[True], out[False]) and out[False].abs().max() > 0.1
    assert all(g.abs().max() > 0 for g in grads[False])
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
