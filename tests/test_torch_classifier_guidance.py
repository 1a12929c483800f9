"""The port's EncoderUNet classifier and classifier guidance against
eo_diffusion_tpu's (f32, CPU, seeded weights carried over by
``encoder_unet_state_dict_from_jax_params``): the classifier's logits, the
input gradient of log p(y | x_t), the guided eps and guided DDIM eta=0 and
DPM-Solver++ trajectories from a shared x_T, all from one jitted JAX
function; guided UniPC, whose fractional timesteps the JAX package's table
lookup does not take, against its own grid's sigmas; the classifier CLI's
schedule against optax's; and the train_classifier -> guided inference
drive on the tiny preset with ``--device cpu``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eo_diffusion_torch.diffusion import classifier_guidance as TCG
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_torch.models import encoder_unet as TE
from eo_diffusion_torch.train.lr_schedules import warmup_cosine_decay
from eo_diffusion_torch.weights import encoder_unet_state_dict_from_jax_params
from eo_diffusion_tpu.diffusion import classifier_guidance as JCG
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from eo_diffusion_tpu.models import encoder_unet as JE
from torch_parity import closed_form_denoiser, fill_params, one_torch_thread, rel_err  # noqa: F401

REL_TOL = 1e-5  # f32 logits: max |port - jax| / max |jax|
GRAD_TOL = 1e-5  # input gradient and guided eps: max |port - jax| / max |jax|
TRAJ_TOL = 5e-5  # whole DDIM trajectory
T, STEPS, SCALE = 50, 4, 3.0
# attention at ds 2 (T 16, D 16), a channel change at each level, 3 classes
CLF = dict(image_size=8, in_channels=3, model_channels=16, num_classes=3, num_res_blocks=1,
           attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2)


@pytest.fixture(scope="module")
def twin():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    x_T = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    t = np.array([7, 33], np.int32)
    y = np.array([2, 0], np.int32)
    clf = JE.EncoderUNet(JE.EncoderUNetConfig(**CLF))
    params = fill_params(jax.eval_shape(clf.init, jax.random.PRNGKey(0), jnp.asarray(x),
                                        jnp.asarray(t)), 5)
    jd = JGD.create(timesteps=T, image_size=8, in_channels=3)

    @jax.jit
    def run(p, x, t, y, x_T):
        classifier_fn = lambda xx, tt: clf.apply(p, xx, tt)
        guided = JCG.classifier_guided(jd, closed_form_denoiser(jnp), classifier_fn, y, SCALE)

        def log_prob(xx):
            logits = classifier_fn(xx, t)
            logp = jax.nn.log_softmax(logits, axis=-1)
            return jnp.sum(jnp.take_along_axis(logp, y[:, None], axis=1)), logits

        (_, logits), grad = jax.value_and_grad(log_prob, has_aux=True)(x)
        traj = jd.ddim_sample(guided, jax.random.PRNGKey(1), 2, num_steps=STEPS, x_T=x_T).x
        dpm = jd.dpm_sample(guided, jax.random.PRNGKey(1), 2, num_steps=STEPS, x_T=x_T).x
        return logits, grad, traj, dpm

    logits, grad, traj, dpm = (np.asarray(r)
                               for r in run(params, *map(jnp.asarray, (x, t, y, x_T))))
    # the guided eps of JAX's classifier_guided, from its gradient: eps - sqrt(1 - acp_t) s g
    somacp = np.asarray(jd.schedule.sqrt_one_minus_alphas_cumprod, np.float32)[t]
    eps = np.asarray(closed_form_denoiser(jnp)(jnp.asarray(x), jnp.asarray(t)))
    refs = (logits, grad, eps - somacp[:, None, None, None] * np.float32(SCALE) * grad, traj,
            dpm)
    model = TE.EncoderUNet(TE.EncoderUNetConfig(**CLF)).eval().requires_grad_(False)
    sd = encoder_unet_state_dict_from_jax_params(params, model.config)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    ins = dict(x=torch.from_numpy(x), t=torch.from_numpy(t).long(),
               y=torch.from_numpy(y).long(), x_T=torch.from_numpy(x_T), params=params)
    return model, ins, refs


def test_classifier_logits_match_jax(twin):
    model, ins, (logits, *_) = twin
    with torch.no_grad():
        out = model(ins["x"], ins["t"])
    assert out.dtype == torch.float32 and out.shape == (2, CLF["num_classes"])
    assert rel_err(out, logits) <= REL_TOL
    # the JAX module names, in call order
    assert [name for _, name in model.layers] == [
        "enc_0_0", "down_0", "enc_1_0", "enc_attn_1_0", "mid_0", "mid_1"]


def test_converter_refuses_a_foreign_leaf(twin):
    _, ins, _ = twin
    extra = dict(ins["params"]["params"], stray={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError, match="leaves"):
        encoder_unet_state_dict_from_jax_params({"params": extra}, TE.EncoderUNetConfig(**CLF))


def test_input_gradient_and_guided_eps_match_jax(twin):
    model, ins, (_, grad_ref, eps_ref, *_) = twin
    td = TGD.create(timesteps=T, image_size=8, in_channels=3)
    guided = TCG.classifier_guided(td, closed_form_denoiser(torch), model, ins["y"], SCALE)
    with torch.inference_mode():  # as the sampling CLI calls it
        grad = TCG.log_prob_grad(model, ins["x"], ins["t"], ins["y"])
        eps = guided(ins["x"], ins["t"], None, None)
    assert grad.dtype == torch.float32 and rel_err(grad, grad_ref) <= GRAD_TOL
    assert rel_err(eps, eps_ref) <= GRAD_TOL
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_guided_trajectory_matches_jax(twin, sampler):
    """Guided DDIM eta 0 and DPM-Solver++(2M) (integer timesteps) from one x_T."""
    model, ins, refs = twin
    traj_ref = refs[3] if sampler == "ddim" else refs[4]
    td = TGD.create(timesteps=T, image_size=8, in_channels=3)
    guided = TCG.classifier_guided(td, closed_form_denoiser(torch), model, ins["y"], SCALE)
    sample = getattr(td, f"{sampler}_sample")
    with torch.inference_mode():
        out = sample(guided, 2, device="cpu", num_steps=STEPS, x_T=ins["x_T"]).x
        plain = sample(closed_form_denoiser(torch), 2, device="cpu", num_steps=STEPS,
                       x_T=ins["x_T"]).x
    assert rel_err(out, traj_ref) <= TRAJ_TOL
    assert rel_err(plain, traj_ref) > 100 * TRAJ_TOL  # the guidance moved the trajectory


def test_guided_unipc_takes_the_grids_sigma(twin):
    """UniPC calls the model at fractional timesteps: the guidance's
    sqrt(1 - acp_t) there is the sigma of UniPC's own grid, the table's at
    an integer t, and the guided sampler runs and moves off the unguided
    one (the JAX package's table lookup cannot take such a t)."""
    from eo_diffusion_torch.diffusion.unipc import continuous_time_tables

    model, ins, _ = twin
    td = TGD.create(timesteps=T, image_size=8, in_channels=3)
    t_seq, _, sigmas, _ = continuous_time_tables(td.schedule, STEPS)
    got = TCG.noise_std(td, torch.from_numpy(t_seq)).flatten()
    np.testing.assert_allclose(got.numpy(), sigmas, rtol=1e-6)
    ints = torch.arange(T)
    np.testing.assert_allclose(TCG.noise_std(td, ints.float()).flatten().numpy(),
                               TCG.noise_std(td, ints).flatten().numpy(), rtol=1e-6)
    guided = TCG.classifier_guided(td, closed_form_denoiser(torch), model, ins["y"], SCALE)
    with torch.inference_mode():
        out = td.unipc_sample(guided, 2, device="cpu", num_steps=STEPS, x_T=ins["x_T"]).x
        plain = td.unipc_sample(closed_form_denoiser(torch), 2, device="cpu",
                                num_steps=STEPS, x_T=ins["x_T"]).x
    assert bool(torch.isfinite(out).all()) and rel_err(out, plain) > 1e-3


def test_guidance_needs_an_eps_model():
    td = TGD.create(timesteps=T, image_size=8, in_channels=3, objective="v")
    with pytest.raises(AssertionError, match="eps-objective"):
        TCG.classifier_guided(td, closed_form_denoiser(torch), None, torch.zeros(1).long())


@pytest.mark.parametrize("lr,steps", [(3e-4, 2000), (1e-3, 7), (3e-4, 40)])
def test_schedule_matches_optax(lr, steps):
    """The classifier CLI's table against optax's warmup_cosine_decay_schedule
    value for value, past the end too, to 1e-7 of the peak (XLA's float32
    cos parts from the correctly rounded one in the last bit)."""
    ref_fn = optax.warmup_cosine_decay_schedule(0.0, lr, max(steps // 20, 1), steps, lr * 0.01)
    # one array length for every case, so the eager ops compile once
    ref = np.asarray(ref_fn(jnp.arange(2003)), np.float32)[:steps + 3]
    out = warmup_cosine_decay(0.0, lr, max(steps // 20, 1), steps, lr * 0.01,
                              num_steps=steps + 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7 * lr)
    assert out[0] == 0.0


def test_train_classifier_then_guided_inference(tmp_path, capsys):
    """``cli.train_classifier`` on the tiny preset writes the checkpoint and
    its JSON; ``cli.inference --classifier_ckpt --classifier_scale`` samples
    with its gradient (the labels rotate through the classifier's classes
    for the unconditional denoiser) and moves the samples off the unguided
    ones."""
    from eo_diffusion_torch.cli import inference, train_classifier

    cdir = tmp_path / "clf"
    meta = train_classifier.main(train_classifier.parse_args([
        "--preset", "tiny", "--device", "cpu", "--steps", "2", "--batch_size", "4",
        "--eval_n", "4", "--class_correlated", "--dir", str(cdir)]))
    assert meta["num_classes"] == 5 and set(meta["eval_acc"]) == {"t0", "t_mid", "t_hi"}
    assert np.isfinite(meta["final_loss"]) and meta["steps_per_s"] > 0
    with open(cdir / "classifier.json") as f:
        assert json.load(f)["preset"] == "tiny"
    model, _ = train_classifier.load_classifier(str(cdir), "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    common = ["--preset", "tiny", "--dataset", "synthetic", "--device", "cpu", "--sampler",
              "ddim", "--sampler_steps", "3", "--batch_size", "2", "--n_iter", "1"]
    guided = inference.main(inference.parse_args([
        *common, "--classifier_ckpt", str(cdir), "--classifier_scale", "50",
        "--outdir", str(tmp_path / "g"), "--samples_fid"]))
    assert "classifier guidance: scale=50.0, 5 classes" in capsys.readouterr().out
    plain = inference.main(inference.parse_args([*common, "--outdir", str(tmp_path / "p")]))
    assert np.isfinite(guided["samples"]).all() and guided["samples"].shape == (2, 8, 8, 3)
    assert np.abs(guided["samples"] - plain["samples"]).max() > 1e-3
    # batch j targets the classifier's class j and is named after it
    names = {p.name.split("_")[0] for p in (tmp_path / "g" / "samples_fid").iterdir()}
    assert names == {"class0", "class1"}


@pytest.mark.parametrize("argv,match", [
    (["--classifier_scale", "2"], "needs --classifier_ckpt"),
    (["--classifier_ckpt", "c", "--sampler", "flow"], "flow-process preset"),
    (["--classifier_ckpt", "c", "--deepcache", "2"], "DeepCache"),
    (["--classifier_ckpt", "c", "--guidance_scale", "2"], "pick one"),
])
def test_classifier_flags_keep_the_jax_checks(tmp_path, argv, match):
    from eo_diffusion_torch.cli import inference

    args = inference.parse_args(["--preset", "tiny", "--device", "cpu", "--dataset",
                                 "synthetic", "--outdir", str(tmp_path), *argv])
    with pytest.raises((AssertionError, SystemExit), match=match):
        inference.main(args)
