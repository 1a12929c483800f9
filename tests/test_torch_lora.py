"""The port's LoRA (``train/lora.py``) and ``cli.finetune`` against the JAX
package on the CPU, float32.

The spec is JAX ``lora_spec``'s, key for key and shape for shape (flax
``keystr`` paths, the attention's ``qkv`` / ``proj_out`` included, which are
3-D Conv1d weights in torch), also under ``--targets``; with injected
non-zero A and B the port's merge gives JAX ``lora_merge``'s forward within
1e-5 (relative to the output's largest value), in place and through
``torch.func.functional_call``; B = 0 is the identity bit for bit; a
``lora.npz`` of JAX ``save_lora`` loads in the port and one of the port's
``save_lora`` in JAX ``load_lora``, with the same merged forward. One jitted
JAX function: the UNet's apply. ``cli.finetune`` runs both methods on
``tiny`` and ``cli.inference`` serves each adapter; a latent preset is
refused as in JAX. The torch twins of the layout's transforms equal the
numpy ones."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.cli import finetune as TF
from eo_diffusion_torch.cli import inference
from eo_diffusion_torch.train import lora as TL
from eo_diffusion_torch.weights import _TORCH, _TWIN, torch_transforms
from eo_diffusion_tpu.cli import finetune as JF
from eo_diffusion_tpu.train import lora as JL
from torch_parity import configs, one_torch_thread, port_model, random_params, rel_err  # noqa: F401

UNET = dict(image_size=8, in_channels=3, model_channels=16, out_channels=3, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2)
ALPHA = 4.0
TOL = 1e-5


@pytest.fixture(scope="module")
def twin():
    jcfg, tcfg = configs(**UNET)
    jmodel, params = random_params(jcfg, seed=81)
    rng = np.random.default_rng(82)
    spec = JL.lora_spec(params)
    # non-zero A and B, rank 3 (capped where a side is narrower)
    lora = {}
    for k, shape in sorted(spec.items()):
        d_in, d_out = JL._dims(shape)
        r = min(3, d_in, d_out)
        lora[k] = {"a": rng.normal(size=(d_in, r)).astype(np.float32),
                   "b": (0.1 * rng.normal(size=(r, d_out))).astype(np.float32)}
    x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    apply = jax.jit(jmodel.apply)
    fwd = lambda p: np.asarray(apply(p, jnp.asarray(x), jnp.asarray(t)))
    return dict(tcfg=tcfg, params=params, lora=lora, x=x, t=t, fwd=fwd,
                ref=fwd(JL.lora_merge(params, lora, alpha=ALPHA)),
                base=port_model(tcfg, params))


def _port_forward(model, x, t):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t).long())


def _tensors(lora):
    return {k: {n: torch.from_numpy(np.array(v)) for n, v in ab.items()} for k, ab in lora.items()}


@pytest.mark.parametrize("match", [None, ["qkv", "emb_proj"], ["out_conv"]])
def test_spec_equals_jax(twin, match):
    got = TL.lora_spec(twin["base"], match)
    want = JL.lora_spec(twin["params"], match)
    assert got == want and got
    if match is None:
        assert any("['qkv']" in k for k in got) and any("['proj_out']" in k for k in got)


def test_merged_forward_matches_jax(twin):
    """In place (sampling) and through functional_call (training)."""
    model = copy.deepcopy(twin["base"])
    TL.lora_merge_(model, _tensors(twin["lora"]), alpha=ALPHA)
    assert rel_err(_port_forward(model, twin["x"], twin["t"]), twin["ref"]) <= TOL
    base = twin["base"]
    merged = TL.merged_parameters(base, _tensors(twin["lora"]), alpha=ALPHA)
    with torch.no_grad():
        out = torch.func.functional_call(base, merged, (torch.from_numpy(twin["x"]),
                                                        torch.from_numpy(twin["t"]).long()))
    assert rel_err(out, twin["ref"]) <= TOL
    assert rel_err(_port_forward(base, twin["x"], twin["t"]), twin["ref"]) > 1e-3  # it moved


def test_fresh_adapters_are_the_identity_and_train_alone(twin):
    """lora_init: B = 0, so the merge changes no bit; A ~ N(0, 1/r) from the
    generator; the gradient of a loss through the merge of a frozen base (as
    cli.finetune freezes it) reaches A and B only."""
    base = copy.deepcopy(twin["base"]).requires_grad_(False)
    lora = TL.lora_init(base, rank=4, generator=torch.Generator().manual_seed(0))
    assert sorted(lora) == sorted(TL.lora_spec(base))
    merged = TL.merged_parameters(base, lora)
    own = dict(base.named_parameters())
    assert all(torch.equal(v, own[n]) for n, v in merged.items())
    model = copy.deepcopy(base)
    TL.lora_merge_(model, lora)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), base.parameters()))
    a = torch.cat([ab["a"].detach().flatten() for ab in lora.values()])
    assert abs(float(a.std()) - 0.5) < 0.05  # N(0, 1/4)
    out = torch.func.functional_call(base, merged, (torch.from_numpy(twin["x"]),
                                                    torch.from_numpy(twin["t"]).long()))
    out.square().mean().backward()
    assert all(p.grad is None for p in base.parameters())
    assert all(ab["b"].grad is not None and ab["b"].grad.abs().sum() > 0 for ab in lora.values())


def test_lora_npz_loads_both_ways(twin, tmp_path):
    JF.save_lora(str(tmp_path / "jax"), twin["lora"], {"alpha": ALPHA, "rank": 3})
    lora, meta = TF.load_lora(str(tmp_path / "jax"))
    model = copy.deepcopy(twin["base"])
    TL.lora_merge_(model, lora, alpha=meta["alpha"])
    assert rel_err(_port_forward(model, twin["x"], twin["t"]), twin["ref"]) <= TOL
    TF.save_lora(str(tmp_path / "port"), _tensors(twin["lora"]), {"alpha": ALPHA})
    jlora, jmeta = JF.load_lora(str(tmp_path / "port"))
    assert sorted(jlora) == sorted(twin["lora"]) and jmeta["alpha"] == ALPHA
    out = twin["fwd"](JL.lora_merge(twin["params"], jlora, alpha=jmeta["alpha"]))
    np.testing.assert_array_equal(out, twin["ref"])


@pytest.mark.parametrize("name", sorted(_TORCH))
def test_torch_twins_equal_the_numpy_transforms(name):
    pair = next(p for p, n in _TWIN.items() if n == name)
    from eo_diffusion_torch import weights as W

    np_pair = next(v for v in (W._ID, W._TRANSPOSE, W._HWIO, W._CONV1D, W._TCONV)
                   if v[1] is pair)
    shape = {"id": (2, 3, 4), "transpose": (3, 5), "hwio": (3, 2, 4, 5), "conv1d": (4, 6),
             "tconv": (3, 2, 4, 5)}[name]
    a = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    to_torch, to_flax = torch_transforms(name)
    w = to_torch(torch.from_numpy(a))
    np.testing.assert_array_equal(w.numpy(), np_pair[0](a))
    np.testing.assert_array_equal(to_flax(w).numpy(), a)
    np.testing.assert_array_equal(to_flax(w).numpy(), np_pair[1](np_pair[0](a)))


@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory):
    """A port checkpoint of the tiny preset's UNet from two cli.train steps."""
    import os

    from eo_diffusion_torch.cli import train

    d = tmp_path_factory.mktemp("ft")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        res = train.main(train.parse_args([
            "--preset", "tiny", "--dataset", "synthetic", "--device", "cpu", "--batch_size",
            "4", "--epochs", "1", "--steps_per_epoch", "2", "--sample_every", "0",
            "--save_every", "0", "--dir", "results/base"]))
    finally:
        os.chdir(cwd)
    return d, res["checkpoint"]


@pytest.mark.parametrize("method", ["lora", "controlnet"])
def test_finetune_cli_then_serve(base_ckpt, method):
    """Three steps of cli.finetune on tiny, its files, then cli.inference
    with the adapter (--lora DIR or --controlnet DIR)."""
    d, ckpt = base_ckpt
    out = d / f"adapter_{method}"
    res = TF.main(TF.parse_args(["--method", method, "--preset", "tiny", "--ckpt", ckpt,
                                 "--dataset", "synthetic", "--steps", "3", "--batch_size", "4",
                                 "--lora_rank", "2", "--device", "cpu", "--dir", str(out)]))
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    files = {"lora": {"lora.npz", "lora.json"},
             "controlnet": {"controlnet.npz", "controlnet.json"}}[method]
    assert {p.name for p in out.iterdir()} == files
    if method == "lora":
        assert res["n_lora"] == TL.lora_param_count(res["lora"]) > 0
        assert any(float(ab["b"].detach().abs().sum()) > 0 for ab in res["lora"].values())
    flag = "--lora" if method == "lora" else "--controlnet"
    run = inference.main(inference.parse_args([
        "--preset", "tiny", "--dataset", "synthetic", "--device", "cpu", "--sampler", "ddim",
        "--sampler_steps", "3", "--batch_size", "2", "--n_iter", "0", "--ckpt", ckpt,
        flag, str(out), "--outdir", str(d / f"samples_{method}")]))
    assert run["samples"].shape == (2, 8, 8, 3) and np.isfinite(run["samples"]).all()


def test_a_latent_preset_is_refused():
    with pytest.raises(AssertionError, match="pixel-space presets"):
        TF.main(TF.parse_args(["--preset", "tiny-latent", "--ckpt", "none", "--device", "cpu"]))
