"""The port's first stage (eo_diffusion_torch.models.autoencoder and
train/ae_trainer) against the JAX package's, f32 on the CPU: a tiny
ConvAutoencoder with every parameter randomised, carried over by
``ae_state_dict_from_jax_params``. One jitted JAX function returns encode,
decode, the forward and the ``ae_trainer`` loss with its gradients; one
optax Adam step and the first-batch ``scale_factor`` are held against the
port's ``train_autoencoder``. Also ``_cycle``'s two behaviours, the
``save_ae`` / ``load_ae`` round trip and the latent presets' fields."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.cli import presets as TP
from eo_diffusion_torch.models import autoencoder as TA
from eo_diffusion_torch.train import ae_trainer as TAT
from eo_diffusion_torch.weights import ae_state_dict_from_jax_params
from eo_diffusion_tpu.cli import presets as JP
from eo_diffusion_tpu.models import autoencoder as JA
from torch_parity import fill_params, one_torch_thread, rel_err  # noqa: F401

# f32 parity of outputs, the loss, the params after one Adam step and
# scale_factor: max |torch - jax| / max |jax|; of the gradients: max |torch -
# jax| of each tensor over the largest |jax| gradient of any tensor
REL_TOL = 1e-5
# the conv biases that feed a GroupNorm of one channel a group (16 and 32
# channels), which removes them: their exact gradient is zero, and both
# sides' are rounding noise (~1e-9) that Adam scales to steps of up to lr;
# there each side's step is held to lr
NORMED_BIASES = ("enc_stem.bias", "enc_down0.bias", "dec_up0.bias", "dec_up1.bias")
SIZE, N, LATENT_REG, LR = 16, 2, 1e-4, 2e-3
CFG = dict(in_channels=3, latent_channels=4, base_channels=16, num_down=2)


@pytest.fixture(scope="module")
def twin():
    """The JAX AE's outputs, loss and gradients on seeded inputs (and the
    jitted function that gives them), with the JAX params."""
    jmodel = JA.ConvAutoencoder(JA.AutoencoderConfig(**CFG))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    params = fill_params(shapes, seed=21)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(N, SIZE, SIZE, 3)).astype(np.float32)
    z = rng.normal(size=(N, SIZE // 4, SIZE // 4, 4)).astype(np.float32)

    @jax.jit
    def run(params, x, z):
        def loss_fn(p):  # train/ae_trainer.py:97-105
            zz = jmodel.apply(p, x, method="encode")
            rec_l = jnp.mean((jmodel.apply(p, zz, method="decode") - x) ** 2)
            return rec_l + LATENT_REG * jnp.mean(zz.astype(jnp.float32) ** 2), rec_l

        (loss, rec_l), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return (jmodel.apply(params, x, method="encode"),
                jmodel.apply(params, z, method="decode"), jmodel.apply(params, x),
                loss, rec_l, grads)

    return run, params, x, z, jax.tree.map(np.asarray, run(params, jnp.asarray(x),
                                                           jnp.asarray(z)))


def port_ae(params):
    tcfg = TA.AutoencoderConfig(**CFG)
    model = TA.ConvAutoencoder(tcfg)
    model.load_state_dict(ae_state_dict_from_jax_params(params, tcfg), strict=True)
    return model


def test_encode_decode_forward_match_jax(twin):
    _, params, x, z, (enc, dec, fwd, *_) = twin
    model = port_ae(params).eval()
    with torch.no_grad():
        got = (model.encode(torch.from_numpy(x)), model.decode(torch.from_numpy(z)),
               model(torch.from_numpy(x)))
    assert got[0].shape == (N, SIZE // 4, SIZE // 4, 4) and got[2].shape == x.shape
    assert got[1].dtype == torch.float32
    for out, ref in zip(got, (enc, dec, fwd)):
        assert np.abs(ref).max() > 0.1  # no zero layer
        assert rel_err(out, ref) <= REL_TOL


def test_stride2_windows_sit_on_the_jax_pixels():
    """The stride-2 conv's output grid and borders: with a kernel that reads
    only its top-left tap, output (i, j) is input (2i - 1, 2j - 1), zero at
    the first row and column, as flax's Conv with explicit (1, 1) padding
    places it."""
    conv = TA.ConvAutoencoder(TA.AutoencoderConfig(**CFG)).enc_down0
    with torch.no_grad():
        conv.weight.zero_()
        conv.bias.zero_()
        conv.weight[:, 0, 0, 0] = 1.0
        x = torch.arange(SIZE * SIZE, dtype=torch.float32).reshape(1, SIZE, SIZE, 1) + 1
        y = conv(x.expand(1, SIZE, SIZE, 16).contiguous())[0, :, :, 0]
    assert y.shape == (SIZE // 2, SIZE // 2)
    want = torch.zeros(SIZE // 2, SIZE // 2)
    want[1:, 1:] = x[0, 1:-1:2, 1:-1:2, 0]
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_ae_loss_and_gradients_match_jax(twin):
    _, params, x, _, (*_, loss, rec_l, grads) = twin
    tcfg = TA.AutoencoderConfig(**CFG)
    model = port_ae(params)
    got, got_rec = TAT.ae_loss(model, torch.from_numpy(x), LATENT_REG)
    got.backward()
    assert rel_err(got, loss) <= REL_TOL and rel_err(got_rec, rec_l) <= REL_TOL
    want = ae_state_dict_from_jax_params(grads, tcfg)
    top = max(float(g.abs().max()) for g in want.values())
    for name, prm in model.named_parameters():
        assert float((prm.grad - want[name]).abs().max()) <= REL_TOL * top, name
    assert max(float(want[k].abs().max()) for k in NORMED_BIASES) <= REL_TOL * top


def test_train_step_and_scale_factor_match_jax(twin):
    """One step of ``train_autoencoder`` against optax's ``adam`` on the JAX
    gradients (its first step, bias-corrected: ``p - lr * g / (|g| + eps)``,
    in numpy), and ``scale_factor = 1 / std(encode(first))`` with the
    updated weights against the JAX encoder's."""
    run, params, x, z, (*_, grads) = twin
    new_params = jax.tree.map(lambda p, g: p - LR * g / (np.abs(g) + 1e-8), params, grads)
    z_new = np.asarray(run(new_params, jnp.asarray(x), jnp.asarray(z))[0])
    want_scale = 1.0 / max(float(z_new.std()), 1e-6)
    other = np.random.default_rng(1).uniform(-1, 1, size=x.shape).astype(np.float32)
    model, scale, losses = TAT.train_autoencoder(port_ae(params), [x, other], steps=1, lr=LR,
                                                 latent_reg=LATENT_REG)
    cfg = TA.AutoencoderConfig(**CFG)
    want = ae_state_dict_from_jax_params(new_params, cfg)
    init = ae_state_dict_from_jax_params(params, cfg)
    for name, prm in model.named_parameters():
        if name in NORMED_BIASES:
            assert float((prm.detach() - init[name]).abs().max()) <= LR * (1 + 1e-5), name
        else:
            assert rel_err(prm, want[name]) <= REL_TOL, name
    assert losses == [] and abs(scale - want_scale) / want_scale <= REL_TOL


class _Counting:
    """A re-iterable source that counts how often it is iterated."""

    def __init__(self, items):
        self.items, self.iters = items, 0

    def __iter__(self):
        self.iters += 1
        return iter(list(self.items))


def test_cycle_reiterates_or_replays():
    """A re-iterable source is iterated anew each epoch (no cache); a
    one-shot generator is replayed from its cached items; an empty source
    raises."""
    src = _Counting([1, 2])
    it = TAT._cycle(src, cap=9)
    assert [next(it) for _ in range(7)] == [1, 2, 1, 2, 1, 2, 1] and src.iters == 5
    gen = (i for i in (1, 2, 3))
    it = TAT._cycle(gen, cap=2)
    assert [next(it) for _ in range(7)] == [1, 2, 3, 1, 2, 1, 2]
    with pytest.raises(RuntimeError, match="yielded nothing"):
        next(TAT._cycle(_Counting([]), cap=3))
    with pytest.raises(AssertionError, match="empty"):
        next(TAT._cycle((i for i in ()), cap=3))
    # train_autoencoder draws the first batch and one a step from the cycle:
    # six items, three epochs of two; iter() twice to tell a generator apart,
    # then once an epoch after the first
    data = np.random.default_rng(2).uniform(-1, 1, size=(2, 8, 8, 3)).astype(np.float32)
    src = _Counting([data, data])
    cfg = TA.AutoencoderConfig(in_channels=3, latent_channels=4, base_channels=8, num_down=1)
    _, scale, losses = TAT.train_autoencoder(TA.ConvAutoencoder(cfg), src, steps=5,
                                             log_every=2)
    assert src.iters == 4 and len(losses) == 3 and np.isfinite(scale)


def test_save_load_round_trip_and_orbax_refusal(tmp_path, twin):
    _, params, x, _, (enc, *_) = twin
    cfg = TA.AutoencoderConfig(**CFG)
    assert not TAT.ae_exists(str(tmp_path / "ae")) and not TAT.ae_exists(None)
    TAT.save_ae(str(tmp_path / "ae"), cfg, port_ae(params), 1.25)
    with open(tmp_path / "ae" / "ae_meta.json") as f:
        meta = json.load(f)
    assert meta == {**{k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"},
                    "scale_factor": 1.25}
    assert TAT.ae_exists(str(tmp_path / "ae"))
    model, scale = TAT.load_ae(str(tmp_path / "ae"))
    assert scale == 1.25 and model.config == cfg
    enc_fn, _ = TAT.make_codec(model)
    assert not any(p.requires_grad for p in model.parameters()) and not model.training
    assert rel_err(enc_fn(torch.from_numpy(x)), enc) <= REL_TOL
    # a first stage the JAX package saved: orbax's params/ and the same sidecar
    jdir = tmp_path / "jax_ae"
    os.makedirs(jdir / "params")
    with open(jdir / "ae_meta.json", "w") as f:
        json.dump(meta, f)
    assert TAT.ae_exists(str(jdir))
    with pytest.raises(NotImplementedError, match="tools/jax_ckpt_to_torch.py"):
        TAT.load_ae(str(jdir))


LATENT_PRESETS = ("latent64", "tiny-latent", "latent256", "latent256-cr", "tiny-latent-cr",
                  "tiny-latent-dit", "tiny-latent-flow")


@pytest.mark.parametrize("name", LATENT_PRESETS)
def test_latent_presets_match_jax(name):
    """Every field the port's Preset has holds the JAX value; the backbone
    and the process are sized to the latent grid; the first stage is f32."""
    got, want = TP.get_preset(name), JP.get_preset(name)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.is_latent and (got.latent_size, got.latent_channels) == (
        want.latent_size, want.latent_channels)
    cfg = got.model_config(cond_channels=got.latent_channels if got.cond_type else 0)
    jcfg = want.model_config(cond_channels=want.latent_channels if want.cond_type else 0)
    assert (cfg.image_size, cfg.in_channels, cfg.out_channels) == (
        jcfg.image_size, jcfg.in_channels, jcfg.out_channels)
    proc = TP.build_process(got, got.timesteps, got.image_size, cond_type=got.cond_type)
    assert (proc.image_size, proc.in_channels) == (got.latent_size, got.latent_channels)
    ae, jae = got.ae_config(), want.ae_config()
    assert ae.dtype == torch.float32 and all(
        getattr(ae, f) == getattr(jae, f)
        for f in ("in_channels", "latent_channels", "base_channels", "num_down"))
