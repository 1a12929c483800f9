"""The port's Trainer against the JAX Trainer (f32, CPU): a few steps from the
same initial state and the same batches.

The JAX step draws its own randomness; the test recovers it. ``Trainer._rng``
starts as ``PRNGKey(cfg.seed)`` (trainer.py:387), each step takes
``split(_rng)[1]`` (:534), the loss splits once more for dropout (:97) and
``train_loss`` draws ``t = randint(split(rng, 3)[0], (n,), 0, T)``
(gaussian.py:439-441). The noise rides the batch on both sides
(``batch["noise"]``, trainer.py:117-121), and the port takes the recovered
timesteps as ``batch["t"]``. Dropout is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion as TGD
from eo_diffusion_torch.train.trainer import Trainer as TTrainer
from eo_diffusion_torch.train.trainer import TrainerConfig as TConfig
from eo_diffusion_torch.weights import load_jax_train_state, state_dict_from_jax_params
from eo_diffusion_tpu.diffusion.gaussian import GaussianDiffusion as JGD
from eo_diffusion_tpu.train.trainer import Trainer as JTrainer
from eo_diffusion_tpu.train.trainer import TrainerConfig as JConfig
from eo_diffusion_tpu.train.trainer import TrainState as JState
from torch_parity import configs, one_torch_thread, random_params  # noqa: F401

T, BS, STEPS, SPE = 10, 8, 6, 4
CLASSES, CLIP = 5, 0.05
UNET = dict(image_size=8, in_channels=6, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
            num_classes=CLASSES)
# One JAX trainer with every option of the step at once (its jitted step costs
# seconds to compile): a global-norm clip below the gradient's norm, so that
# it acts; two micro-steps an update; concat conditioning; class labels. The
# port-only tests further down take the options one at a time.
COMMON = dict(lr=2e-3, batch_size=BS, epochs=2, timesteps=T, model_ema_steps=2, seed=3,
              grad_clip=CLIP, grad_accum=2, cond_type="concat", num_classes=CLASSES)
DIFFUSION = dict(timesteps=T, image_size=8, in_channels=3, cond_type="concat")


def _rel_l2(tensors, refs):
    num = sum(float(((a.detach().numpy() - np.asarray(b)) ** 2).sum())
              for a, b in zip(tensors, refs))
    return (num / sum(float((np.asarray(b) ** 2).sum()) for b in refs)) ** 0.5


def _batches(rng):
    return [{"image": rng.uniform(-1, 1, (BS, 8, 8, 3)).astype(np.float32),
             "noise": rng.normal(size=(BS, 8, 8, 3)).astype(np.float32),
             "cond": rng.uniform(-1, 1, (BS, 8, 8, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, (BS,)).astype(np.int32)}
            for _ in range(STEPS)]


def _find(tree, attr):
    """The first node of an optax state that has ``attr`` (MultiStepsState's
    ``acc_grads``, ScaleByAdamState's ``mu``)."""
    if hasattr(tree, attr):
        return getattr(tree, attr)
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            found = _find(sub, attr)
            if found is not None:
                return found
    return None


@pytest.fixture(scope="module")
def runs():
    """Both trainers run STEPS micro-steps from one seeded state; returns what
    the tests compare."""
    from eo_diffusion_torch.models.unet import UNet
    from eo_diffusion_tpu.parallel.mesh import make_mesh

    jcfg, tcfg = configs(**UNET)
    jmodel, params = random_params(jcfg, seed=31, cond_channels=3)
    jtr = JTrainer(JConfig(**COMMON), jmodel, JGD.create(**DIFFUSION), SPE,
                   mesh=make_mesh(jax.devices()[:1]))  # one device: a cheaper compile
    jstate = jtr.shard_state(JState.create(jax.tree.map(jnp.asarray, params), jtr.tx))
    batches = _batches(np.random.default_rng(32))

    # the JAX trainer's own timestep draws
    ts, key = [], jax.random.PRNGKey(COMMON["seed"])
    for _ in range(STEPS):
        key, step_rng = jax.random.split(key)
        loss_rng = jax.random.split(step_rng)[0]
        ts.append(np.asarray(jax.random.randint(jax.random.split(loss_rng, 3)[0],
                                                (BS,), 0, T)))

    ttr = TTrainer(TConfig(**COMMON), UNet(tcfg), TGD.create(**DIFFUSION), SPE, device="cpu")
    tstate = load_jax_train_state(ttr.init(), tcfg, params, params)
    jout, tout, snaps = [], [], {}
    for i, (b, t) in enumerate(zip(batches, ts)):
        jstate, m = jtr.step(jstate, b)
        jout.append({k: float(v) for k, v in m.items()})
        tstate, m = ttr.step(tstate, dict(b, t=t))
        tout.append({k: float(v) for k, v in m.items()})
        if i == 0:  # inside the first accumulation: the running mean is g1
            snaps["jg1"] = jax.tree.map(np.asarray, _find(jstate.opt_state, "acc_grads"))
            snaps["tg1"] = [g.clone() for g in tstate.acc_grads]
        if i == 1:  # after the first update: Adam's first moment of clip(mean(g1, g2))
            snaps["jmu"] = jax.tree.map(np.asarray, _find(jstate.opt_state, "mu"))
            snaps["tmu"] = {n: tstate.optimizer.state[p]["exp_avg"].clone()
                            for n, p in tstate.model.named_parameters()}
    names = [n for n, _ in tstate.model.named_parameters()]
    return dict(jout=jout, tout=tout, jlrs=[jtr.current_lr(s) for s in range(STEPS)],
                tlrs=[ttr.current_lr(s) for s in range(STEPS)],
                jg1=state_dict_from_jax_params(snaps["jg1"], tcfg),
                tg1=dict(zip(names, snaps["tg1"])),
                jmu=state_dict_from_jax_params(snaps["jmu"], tcfg), tmu=snaps["tmu"],
                jstate=jax.tree.map(np.asarray, jstate), tstate=tstate, tcfg=tcfg, ttr=ttr,
                init=state_dict_from_jax_params(params, tcfg))


def test_losses_and_grad_norms_every_step(runs):
    for j, t in zip(runs["jout"], runs["tout"]):
        # the bar of tests/test_train.py's step-parity check
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=2e-4)
    assert min(j["grad_norm"] for j in runs["jout"]) > CLIP  # the clip acted


def test_lr_every_step(runs):
    """state.step counts micro-steps; the table is indexed by optimizer step."""
    assert runs["tlrs"] == runs["jlrs"]
    assert runs["tlrs"][0] == runs["tlrs"][1] != runs["tlrs"][2]


def _leafwise(got, want, tol):
    """Relative L2 per leaf. A conv bias or an embedding projection in front
    of a GroupNorm whose groups hold one channel (width 32) has a zero gradient
    up to rounding noise; such a leaf is held against 1e-2 of the mean leaf
    norm instead of its own."""
    assert set(got) == set(want)
    floor = 1e-2 * float(np.mean([float(w.norm()) for w in want.values()]))
    for name, w in want.items():
        rel = float((got[name] - w).norm() / w.norm().clamp(min=floor))
        assert rel <= tol, (name, rel)


def test_first_step_gradients_leaf_by_leaf(runs):
    """The raw gradient of micro-step 1, read on both sides from the
    accumulator (optax.MultiSteps keeps the running mean, which is g1 there)."""
    _leafwise(runs["tg1"], runs["jg1"], 1e-4)


def test_first_update_moment_leaf_by_leaf(runs):
    """Adam's first moment after the first update is 0.1 * clip(mean(g1, g2)):
    accumulation, then the clip, then AdamW, in optax's order."""
    _leafwise(runs["tmu"], runs["jmu"], 1e-4)


def test_final_parameters_and_ema(runs):
    """Adam divides by sqrt(v): a leaf element whose gradient is near zero
    moves by up to lr a step whichever way rounding tips its sign, so the
    comparison is a global relative L2 over all leaves, not elementwise.
    3 updates at lr <= 2e-3 against weights of rms ~0.1 bound that drift by
    about 6e-2 if every sign tipped; rounding tips few elements, and 1e-3
    holds."""
    tstate, jstate, tcfg, init = (runs[k] for k in ("tstate", "jstate", "tcfg", "init"))
    assert tstate.step == int(jstate.step) == STEPS
    named, ema = dict(tstate.model.named_parameters()), dict(tstate.ema_model.named_parameters())
    for got, tree in ((named, jstate.params), (ema, jstate.ema_params)):
        want = state_dict_from_jax_params(tree, tcfg)
        assert _rel_l2([got[k] for k in want], [want[k] for k in want]) <= 1e-3
    # both moved, and the EMA is not the raw weights
    assert _rel_l2([named[k] for k in init], [init[k] for k in init]) > 1e-3
    assert _rel_l2([ema[k] for k in init], [named[k].detach() for k in init]) > 1e-4


def test_optimizer_follows_optax_defaults(runs):
    group = runs["tstate"].optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)
    assert runs["tstate"].opt_step == STEPS // 2 and runs["tstate"].mini_step == 0


PLAIN_UNET = dict(UNET, in_channels=3, num_classes=None)


def _port_trainer(**kw):
    from eo_diffusion_torch.models.unet import UNet, UNetConfig
    from eo_diffusion_torch.weights import randomize_parameters

    cfg = TConfig(lr=1e-3, batch_size=BS, epochs=1, timesteps=T, warmup_epochs=0, **kw)
    model = randomize_parameters(UNet(UNetConfig(**PLAIN_UNET)), seed=0)
    tr = TTrainer(cfg, model, TGD.create(timesteps=T, image_size=8), 10, device="cpu")
    return tr, tr.init(), {"image": np.full((BS, 8, 8, 3), 0.3, np.float32)}


def _raw_grads(tr, state, batch):
    tr.loss(state, batch).backward()
    grads = [p.grad.clone() for p in state.params]
    state.model.zero_grad()
    return grads


def _fixed(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (BS, 8, 8, 3)).astype(np.float32),
            "noise": rng.normal(size=(BS, 8, 8, 3)).astype(np.float32),
            "t": rng.integers(0, T, (BS,))}


def test_grad_clip_alone_scales_what_reaches_adam():
    tr, state, _ = _port_trainer(grad_clip=0.01)
    g = _raw_grads(tr, state, _fixed(0))
    norm = torch.linalg.vector_norm(torch.stack([x.norm() for x in g]))
    state, m = tr.step(state, _fixed(0))
    assert float(m["grad_norm"]) == pytest.approx(float(norm), rel=1e-6) and norm > 0.01
    for p, x in zip(state.params, g):  # exp_avg = (1 - b1) * clipped gradient
        torch.testing.assert_close(state.optimizer.state[p]["exp_avg"],
                                   0.1 * x * (0.01 / norm), rtol=1e-4, atol=1e-9)


def test_grad_accum_alone_averages_two_micro_steps():
    tr, state, _ = _port_trainer(grad_accum=2)
    g1, g2 = _raw_grads(tr, state, _fixed(1)), _raw_grads(tr, state, _fixed(2))
    before = [p.detach().clone() for p in state.params]
    state, _ = tr.step(state, _fixed(1))
    assert all(torch.equal(a, b) for a, b in zip(before, state.params))  # no update yet
    assert (state.step, state.opt_step, state.mini_step) == (1, 0, 1)
    state, _ = tr.step(state, _fixed(2))
    assert (state.step, state.opt_step, state.mini_step) == (2, 1, 0)
    for p, a, b in zip(state.params, g1, g2):
        torch.testing.assert_close(state.optimizer.state[p]["exp_avg"], 0.1 * (a + b) / 2,
                                   rtol=1e-4, atol=1e-9)
    assert tr.ema_every == 2 * tr.cfg.model_ema_steps


def test_skip_nonfinite_leaves_parameters_and_moments_untouched():
    """What tests/test_skip_nonfinite.py shows for the JAX trainer."""
    tr, state, batch = _port_trainer(skip_nonfinite=True)
    state, m = tr.step(state, batch)
    assert int(m["notfinite_count"]) == 0
    snap = lambda: ([p.detach().clone() for p in state.params],
                    [v.clone() for s in state.optimizer.state.values()
                     for v in (s["exp_avg"], s["exp_avg_sq"], s["step"])])
    p_before, moments_before = snap()
    bad = {"image": np.full((BS, 8, 8, 3), np.nan, np.float32)}
    state, m = tr.step(state, bad)
    assert int(m["notfinite_count"]) == 1 and not np.isfinite(float(m["loss"]))
    p_after, moments_after = snap()
    assert all(torch.equal(a, b) for a, b in zip(p_before, p_after))
    assert all(torch.equal(a, b) for a, b in zip(moments_before, moments_after))
    assert state.opt_step == 1 and state.step == 2
    state, m = tr.step(state, batch)  # a clean step applies and resets the streak
    assert int(m["notfinite_count"]) == 0 and state.opt_step == 2
    assert any(not torch.equal(a, b) for a, b in zip(p_before, state.params))
    assert all(torch.isfinite(p).all() for p in state.params)


def test_without_skip_nonfinite_a_nan_batch_poisons_like_the_reference():
    tr, state, batch = _port_trainer()
    state, m = tr.step(state, batch)
    assert "notfinite_count" not in m
    state, _ = tr.step(state, {"image": np.full((BS, 8, 8, 3), np.nan, np.float32)})
    assert not all(torch.isfinite(p).all() for p in state.params)


def test_label_dropout_draws_from_the_explicit_generator():
    from eo_diffusion_torch.models.unet import UNet, UNetConfig

    model = UNet(UNetConfig(**dict(PLAIN_UNET, num_classes=3, class_dropout_prob=0.5)))
    cfg = TConfig(batch_size=BS, epochs=1, timesteps=T, num_classes=3, seed=9)
    seen = []
    model.register_forward_pre_hook(lambda mod, args, kwargs: seen.append(kwargs["y"].clone()),
                                    with_kwargs=True)
    batch = {"image": np.zeros((BS, 8, 8, 3), np.float32), "label": np.arange(BS) % 3}
    for _ in range(2):  # the same seed drops the same labels to the null class 3
        tr = TTrainer(cfg, model, TGD.create(timesteps=T, image_size=8), 10, device="cpu")
        tr.loss(tr.init(), batch)
    assert torch.equal(seen[0], seen[1]) and (seen[0] == 3).any() and (seen[0] != 3).any()


@pytest.mark.parametrize("field,queue", [("fsdp", 16), ("tp", 16), ("sp", 16), ("ep", 16),
                                         ("pp_micro", 16), ("optimizer", 14),
                                         ("fsdp_min_size", 16),
                                         ("moe_aux_weight", 13), ("muon_lr_mult", 14)])
def test_unported_layouts_raise_with_their_queue(field, queue):
    """The layouts of later queues raise naming theirs; moe_aux_weight (queue
    13) is ported and adds nothing for a backbone without experts; the
    optimizer and muon_lr_mult (queue 14) are ported: "muon" builds Muon with
    AdamW and a step moves the parameters, muon_lr_mult alone (AdamW) is
    taken and ignored, as in JAX."""
    value = {"pp_micro": 2, "optimizer": "muon", "fsdp_min_size": 1024,
             "moe_aux_weight": 0.1, "muon_lr_mult": 2.0}.get(field, True)
    if queue == 13:
        tr, state, batch = _port_trainer(**{field: value})
        assert not tr.has_experts and bool(torch.isfinite(tr.loss(state, batch)))
        return
    if queue == 14:
        from eo_diffusion_torch.train.muon import MuonWithAdamW

        tr, state, batch = _port_trainer(**{field: value})
        assert isinstance(state.optimizer, MuonWithAdamW) == (field == "optimizer")
        before = [p.detach().clone() for p in state.params]
        state, m = tr.step(state, batch)
        assert bool(torch.isfinite(m["loss"]))
        assert any(not torch.equal(a, b) for a, b in zip(before, state.params))
        with pytest.raises(ValueError, match="unknown optimizer"):
            _port_trainer(optimizer="sgd")
        return
    with pytest.raises(NotImplementedError, match=f"queue {queue}"):
        _port_trainer(**{field: value})


def test_dpm_preview_sampler():
    """``preview_sampler="dpm"`` previews with DPM-Solver++(2M) from the EMA
    weights: finite samples of the image shape, the same for the same seed;
    an unknown name raises."""
    tr, state, _ = _port_trainer(preview_sampler="dpm", preview_steps=3)
    a, b = (tr.sample(state, 5, n=2) for _ in range(2))
    assert a.shape == (2, 8, 8, 3) and torch.isfinite(a).all() and torch.equal(a, b)
    with pytest.raises(ValueError, match="preview_sampler"):
        _port_trainer(preview_sampler="rk4")


def test_later_fields_carry_the_jax_defaults():
    """fsdp_min_size, moe_aux_weight and muon_lr_mult exist with the JAX
    trainer's defaults, which a trainer accepts (moe_aux_weight counts only
    with experts, which the trainer refuses on their own)."""
    fields = ("fsdp_min_size", "moe_aux_weight", "muon_lr_mult")
    jax_defaults = {f: getattr(JConfig(), f) for f in fields}
    assert {f: getattr(TConfig(), f) for f in fields} == jax_defaults == {
        "fsdp_min_size": 65536, "moe_aux_weight": 0.01, "muon_lr_mult": 1.0}
    _port_trainer(**jax_defaults)
