"""The port's Muon optimizer (``train/muon.py``) against the JAX package's
``muon_with_adamw`` on the CPU, float32.

A tiny class-conditional UNet's tree (seeded, carried over by
``state_dict_from_jax_params``) takes three updates from the same injected
numpy gradients in both packages, under a learning-rate table indexed by
the update (``lr_schedules.set_lr`` on the port's side, a schedule on
optax's) with ``muon_lr_mult`` 2. One jitted JAX function: the update.

Bounds: the AdamW leaves' parameters within 1e-5 relative L2 of JAX's; the
Muon leaves' change over the three updates within 1e-4 relative L2 (five
Newton-Schulz iterations a step amplify the float32 rounding of the two
libraries' products; the readings are 3.8e-6 and 2.6e-6). Among the Muon leaves are a
Dense and convs whose fan-in and fan-out differ (the RMS scale ``sqrt(max(1,
rows / cols))`` is not symmetric), and the attention's ``qkv``, a 3-D Conv1d
weight in torch and a 2-D kernel in flax. A JAX Muon state after two updates
resumes in the port (``tools/jax_ckpt_to_torch.opt_trees``, then
``weights.load_jax_train_state``), and the next update agrees to the same
bounds. The port's own train state round-trips through its checkpoint with
the momentum buffers."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eo_diffusion_torch.models.unet import UNet
from eo_diffusion_torch.train.lr_schedules import set_lr
from eo_diffusion_torch.train.muon import MuonWithAdamW, muon_labels, orthogonalized_update
from eo_diffusion_torch.weights import state_dict_from_jax_params, unet_layout
from eo_diffusion_tpu.train.muon import muon_label_fn, muon_with_adamw
from torch_parity import configs, fill_params, one_torch_thread, random_params  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
UNET = dict(image_size=8, in_channels=3, model_channels=16, out_channels=3, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2, num_classes=3)
TABLE = np.array([1e-2, 3e-3, 5e-3], np.float32)
MULT = 2.0
TOL_ADAMW, TOL_MUON = 1e-5, 1e-4


def _tool():
    path = ROOT / "tools" / "jax_ckpt_to_torch.py"
    spec = importlib.util.spec_from_file_location("_muon_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    return float((got - want).norm() / want.norm())


@pytest.fixture(scope="module")
def runs():
    """JAX: three updates from the seeded tree, the state kept after each.
    The port: the same three updates from the same tree; and a resume from
    JAX's state after two, then the third."""
    jcfg, tcfg = configs(**UNET)
    _, params = random_params(jcfg, seed=71)
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    grads = [fill_params(shapes, seed=72 + i) for i in range(len(TABLE))]
    # the clip that never acts wraps the optimizer as the trainer's does, so
    # the tool's walk finds the state under a chain
    tx = optax.chain(optax.clip_by_global_norm(1e9),
                     muon_with_adamw(lambda c: jnp.asarray(TABLE)[c], muon_lr_mult=MULT))

    @jax.jit
    def jstep(p, st, g):
        up, st = tx.update(g, st, p)
        return optax.apply_updates(p, up), st

    jp, jst = jax.tree.map(jnp.asarray, params), tx.init(params)
    jstates = []
    for g in grads:
        jp, jst = jstep(jp, jst, jax.tree.map(jnp.asarray, g))
        jstates.append((jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jst)))

    def port(model, opt, steps):
        for i in steps:
            gsd = state_dict_from_jax_params(grads[i], tcfg)
            for n, p in model.named_parameters():
                p.grad = gsd[n].clone()
            set_lr(opt, TABLE, i)
            opt.step()
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    model = UNet(tcfg)
    model.load_state_dict(state_dict_from_jax_params(params, tcfg), strict=True)
    opt = MuonWithAdamW(model, lr=float(TABLE[0]), muon_lr_mult=MULT)
    own = port(model, opt, range(len(TABLE)))

    from eo_diffusion_torch.train.trainer import TrainState

    tool = _tool()
    resumed_model = UNet(tcfg)
    state = TrainState(resumed_model, UNet(tcfg), MuonWithAdamW(resumed_model, lr=0.0,
                                                                 muon_lr_mult=MULT))
    p2, st2 = jstates[1]
    trees = tool.opt_trees(st2)
    from eo_diffusion_torch.weights import load_jax_train_state

    load_jax_train_state(state, tcfg, p2, p2, mu=trees["mu"], nu=trees["nu"], step=2,
                         opt_step=int(trees["count"]), momentum=trees["momentum"])
    resumed = port(state.model, state.optimizer, [2])
    return dict(tcfg=tcfg, params=params, jstates=jstates, own=own, resumed=resumed,
                labels=muon_labels(model), init=state_dict_from_jax_params(params, tcfg),
                opt=opt, trees=trees, resumed_state=state)


def _check(got, runs, where):
    """Every leaf of ``got`` against JAX's state after the three updates."""
    want = state_dict_from_jax_params(runs["jstates"][-1][0], runs["tcfg"])
    worst = {"adamw": 0.0, "muon": 0.0}
    for name, w in want.items():
        label = runs["labels"][name][0]
        if label == "muon":  # the change over the updates, not the parameter
            rel = _rel(got[name] - runs["init"][name], w - runs["init"][name])
        else:
            rel = _rel(got[name], w)
        worst[label] = max(worst[label], rel)
        assert rel <= (TOL_MUON if label == "muon" else TOL_ADAMW), (where, name, label, rel)
    return worst


def test_three_updates_match_jax(runs):
    worst = _check(runs["own"], runs, "own")
    assert worst["muon"] > 0.0  # the Muon leaves moved and were compared


def test_a_jax_muon_state_resumes_in_the_port(runs):
    """JAX's state after two updates (params, Adam's mu / nu on the AdamW
    leaves, the Muon momentum on the rest) loaded into the port, then the
    third update: within the same bounds of JAX's third."""
    trees = runs["trees"]
    assert int(trees["count"]) == 2 and trees["momentum"] is not None
    st = runs["resumed_state"].optimizer.state
    kinds = {g["kind"]: g["params"] for g in runs["resumed_state"].optimizer.param_groups}
    assert all("momentum_buffer" in st[p] for p in kinds["muon"])
    assert all(float(st[p]["step"]) == 3.0 for p in kinds["adamw"])  # 2, then the third
    _check(runs["resumed"], runs, "resumed")


def test_labels_match_jax_leaf_for_leaf(runs):
    """``muon_labels`` against ``muon_label_fn`` by the flax path of each
    parameter; the attention's qkv (3-D in torch) is Muon, the label table,
    biases and norm scales AdamW; a Dense and convs of unequal fan-in and
    fan-out are Muon leaves."""
    jlabels = muon_label_fn(runs["params"])["params"]
    get = lambda tree, path: get(tree[path[0]], path[1:]) if path else tree
    labels = runs["labels"]
    for fpath, tname, _, _ in unet_layout(runs["tcfg"]):
        assert labels[tname][0] == get(jlabels, fpath), (tname, fpath)
    assert labels["label_emb.weight"][0] == "adamw"
    assert labels["input_blocks.3.1.qkv.weight"][0] == "muon"
    assert runs["init"]["input_blocks.3.1.qkv.weight"].ndim == 3
    assert labels["time_embed.0.weight"][0] == "muon"  # Dense [16, 64]
    assert labels["input_blocks.0.0.weight"][0] == "muon"  # conv 3x3x3 -> 16: [27, 16]
    assert all(labels[n][0] == "adamw" for n in runs["init"] if n.endswith(".bias"))
    kinds = {g["kind"]: g for g in runs["opt"].param_groups}
    assert kinds["muon"]["lr_mult"] == MULT and kinds["adamw"]["lr_mult"] == 1.0
    assert kinds["muon"]["lr"] == pytest.approx(float(TABLE[-1]) * MULT)
    assert kinds["adamw"]["lr"] == pytest.approx(float(TABLE[-1]))


@pytest.mark.parametrize("shape", [(48, 16), (16, 48), (3, 3, 4, 8), (2, 5, 6)])
def test_orthogonalized_update_scale_and_shape(shape):
    """The update keeps the leaf's shape; its [-1, last axis] matrix has
    singular values in the quintic's band times sqrt(max(1, rows / cols))."""
    g = torch.randn(*shape, generator=torch.Generator().manual_seed(5))
    o = orthogonalized_update(g)
    assert o.shape == g.shape
    m = o.reshape(-1, shape[-1])
    s = torch.linalg.svdvals(m) / max(1.0, m.shape[0] / m.shape[1]) ** 0.5
    assert 0.5 <= float(s.min()) and float(s.max()) <= 1.35


def test_trainer_state_round_trips_with_momentum(tmp_path):
    """``TrainerConfig(optimizer="muon")``: two steps, a checkpoint, a fresh
    trainer restored from it; the momentum buffers come back equal and the
    next step gives the same parameters as the trainer that went on."""
    from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
    from eo_diffusion_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from eo_diffusion_torch.train.trainer import Trainer, TrainerConfig

    _, tcfg = configs(**{**UNET, "num_classes": None})
    rng = np.random.default_rng(9)
    batches = [{"image": rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32),
                "noise": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
                "t": rng.integers(0, 10, (4,))} for _ in range(3)]

    def trainer():
        torch.manual_seed(0)
        cfg = TrainerConfig(lr=1e-3, batch_size=4, epochs=1, timesteps=10, optimizer="muon",
                            muon_lr_mult=3.0, grad_clip=1.0)
        tr = Trainer(cfg, UNet(tcfg), GaussianDiffusion.create(timesteps=10, image_size=8),
                     4, device="cpu")
        return tr, tr.init()

    tr, state = trainer()
    for b in batches[:2]:
        state, _ = tr.step(state, b)
    path = save_checkpoint(str(tmp_path), state.state_dict(), step=2)
    tr2, state2 = trainer()
    state2 = restore_checkpoint(path, state2)
    bufs = lambda s: [s.optimizer.state[p]["momentum_buffer"]
                      for g in s.optimizer.param_groups if g["kind"] == "muon"
                      for p in g["params"]]
    assert bufs(state2) and all(torch.equal(a, b) for a, b in zip(bufs(state), bufs(state2)))
    state, _ = tr.step(state, batches[2])
    state2, _ = tr2.step(state2, batches[2])
    kinds = {g["kind"]: g["lr"] for g in state2.optimizer.param_groups}
    assert kinds["muon"] == pytest.approx(3.0 * kinds["adamw"])
    for a, b in zip(state.model.parameters(), state2.model.parameters()):
        assert torch.equal(a, b)
