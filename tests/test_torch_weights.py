"""The port's weight loaders (eo_diffusion_torch.weights) against the JAX
package's param trees and its torch exporter (tools/convert_ckpt.py)."""

import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import unet as TU
from eo_diffusion_torch.weights import (
    fix_legacy_dict,
    load_reference_checkpoint,
    randomize_parameters,
    state_dict_from_jax_params,
)
from eo_diffusion_tpu.tools.convert_ckpt import params_to_state_dict
from torch_parity import configs, one_torch_thread, random_params  # noqa: F401

BASE = dict(image_size=8, in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=2)
CASES = {
    # conv Downsample (.op) / Upsample (.conv), 1x1 skip convs
    "conv_resample": dict(),
    # ResBlock up/down, FiLM emb width, class embedding, concat-cond input
    "updown_film_class": dict(resblock_updown=True, use_scale_shift_norm=True,
                              num_classes=3, in_channels=5),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw = {**BASE, **CASES[request.param]}
    jcfg, tcfg = configs(**kw)
    _, params = random_params(jcfg, seed=3, cond_channels=kw["in_channels"] - 3)
    return jcfg, tcfg, params


def test_jax_params_load_strictly(case):
    _, tcfg, params = case
    sd = state_dict_from_jax_params(params, tcfg)
    model = TU.UNet(tcfg)
    res = model.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k]), k


def test_reference_key_names_load_unchanged(case):
    """The JAX package's exporter writes the reference's torch key names;
    that dict loads into the port as it is, with the same values."""
    jcfg, tcfg, params = case
    ref_sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
              for k, v in params_to_state_dict(params, jcfg).items()}
    model = TU.UNet(tcfg)
    model.load_state_dict(ref_sd, strict=True)
    ours = state_dict_from_jax_params(params, tcfg)
    assert set(ref_sd) == set(ours)
    for k in ref_sd:
        assert torch.equal(ref_sd[k], ours[k]), k


def test_reference_checkpoint_file(tmp_path):
    """A reference-style .pt: model/model_ema dicts with ``module.`` and
    ``model.`` prefixes, schedule buffers and the dead output head."""
    cfg = TU.UNetConfig(**BASE)
    ema = randomize_parameters(TU.UNet(cfg), seed=1).state_dict()
    live = randomize_parameters(TU.UNet(cfg), seed=2).state_dict()
    extras = {"betas": torch.ones(10), "alphas_cumprod": torch.ones(10),
              "nout.weight": torch.ones(3), "conv_out.bias": torch.ones(3)}
    path = tmp_path / "ckpt.pt"
    torch.save({"model": {**{f"module.{k}": v for k, v in live.items()}, **extras},
                "model_ema": {**{f"model.{k}": v for k, v in ema.items()}, **extras},
                "epoch": 7}, path)
    for use_ema, want in ((True, ema), (False, live)):
        sd = load_reference_checkpoint(str(path), cfg, use_ema=use_ema)
        model = TU.UNet(cfg)
        model.load_state_dict(sd, strict=True)
        assert all(torch.equal(sd[k], want[k]) for k in want)
    # the port's own saved state dict loads through the same function
    torch.save(ema, tmp_path / "port.pt")
    sd = load_reference_checkpoint(str(tmp_path / "port.pt"), cfg)
    assert all(torch.equal(sd[k], ema[k]) for k in ema)


def test_fix_legacy_dict_prefixes_and_nesting():
    w = np.arange(4, dtype=np.float32)
    out = fix_legacy_dict({"state_dict": {"module.model.a.weight": w, "b": torch.ones(2)}})
    assert sorted(out) == ["a.weight", "b"]
    assert torch.is_tensor(out["a.weight"]) and out["a.weight"].tolist() == w.tolist()


def test_randomize_parameters_is_seeded_and_nonzero():
    cfg = TU.UNetConfig(**BASE)
    a = randomize_parameters(TU.UNet(cfg), seed=5).state_dict()
    b = randomize_parameters(TU.UNet(cfg), seed=5).state_dict()
    c = randomize_parameters(TU.UNet(cfg), seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    # a fresh init leaves the zero-init layers at 0; randomized, none is
    assert all(bool(v.abs().max() > 0) for v in a.values())
