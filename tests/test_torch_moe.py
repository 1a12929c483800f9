"""The port's MoE FFN (eo_diffusion_torch.models.moe) and MoE DiT against the
JAX package's, f32 on the CPU, from one jitted JAX function: MoEMLP at top-1
and top-2 with capacity overflow and a planted tie between two experts, the
aux value, and a tiny-moe DiT forward with its aux values; the trainer's
load-balance term on the port alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.models import moe as TM
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params, flax_state_dict
from eo_diffusion_tpu.models import dit as JD
from eo_diffusion_tpu.models import moe as JM
from torch_parity import fill_params, one_torch_thread, rel_err  # noqa: F401

REL_TOL = 1e-5  # f32: max |port - jax| / max |jax|
D, H, E = 16, 32, 4
# (top_k, capacity factor): top-1 and top-2, both past capacity for some tokens
CASES = ((1, 0.75), (2, 0.6))
DIT = dict(image_size=16, in_channels=3, out_channels=3, patch_size=4, hidden_size=64,
           depth=2, num_heads=4, num_experts=4, moe_top_k=2, moe_every=1)


def _experts_scaled(params, rng):
    """Expert weights of unit-scale products (fill_params gives leaves of
    other names a bias's scale)."""
    def fix(path, leaf):
        name = path[-1].key
        if name in ("w_in", "w_out"):
            return (rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[1])).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(fix, params)


def _plant_tie(params):
    """Experts 0 and 1 get the same router column and bias: equal
    probabilities for every token, the lower index must win."""
    r = params["params"]["router"]
    r["kernel"][:, 1] = r["kernel"][:, 0]
    r["bias"][1] = r["bias"][0]
    return params


@pytest.fixture(scope="module")
def twin():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, D)).astype(np.float32)
    mlps = [JM.MoEMLP(D, H, E, top_k=k, capacity_factor=cap) for k, cap in CASES]
    mparams = [_plant_tie(_experts_scaled(fill_params(jax.eval_shape(
        m.init, jax.random.PRNGKey(0), jnp.asarray(x)), 10 + i), rng)) for i, m in enumerate(mlps)]
    jdit = JD.DiT(JD.DiTConfig(**DIT))
    dparams = _experts_scaled(fill_params(jax.eval_shape(
        jdit.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))), 5), rng)
    xd = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.array([999.0, 123.4], np.float32)

    @jax.jit
    def run(mparams, dparams, x, xd, t):
        outs = []
        for m, p in zip(mlps, mparams):
            y, st = m.apply(p, x, mutable=["intermediates"])
            outs.append((y, st["intermediates"]["moe_aux"][0]))
        y, st = jdit.apply(dparams, xd, t, mutable=["intermediates"])
        auxes = jax.tree.leaves(st["intermediates"])
        return outs, (y, sum(auxes) / len(auxes))

    ref = jax.tree.map(np.asarray, run(mparams, dparams, x, xd, t))
    return dict(x=x, xd=xd, t=t, mparams=mparams, dparams=dparams, ref=ref)


def _port_mlp(i, params):
    k, cap = CASES[i]
    m = TM.MoEMLP(D, H, E, top_k=k, capacity_factor=cap)
    m.load_state_dict(flax_state_dict(m, params), strict=True)
    return m


@pytest.mark.parametrize("i", range(len(CASES)))
def test_moe_mlp_matches_jax(twin, i):
    """The output (dropped tokens' rows zero in both) and the aux value."""
    m = _port_mlp(i, twin["mparams"][i]).train()
    y = m(torch.from_numpy(twin["x"]))
    want, aux = twin["ref"][0][i]
    assert y.shape == want.shape and np.abs(want).max() > 0.1
    assert rel_err(y, want) <= REL_TOL
    assert abs(float(m.aux_values[-1].detach()) - float(aux)) <= REL_TOL * abs(float(aux))
    # capacity overflow happened: some (token, slot) was dropped, and a token
    # that lost every slot has a zero row in both
    with torch.no_grad():
        probs = torch.softmax(m.router(torch.from_numpy(twin["x"]).reshape(-1, D)), -1)
    _, keep = TM.assign_slots(TM.route(probs, m.top_k), E, m.capacity(24))
    assert not bool(keep.all())
    lost = ~keep.any(1).numpy()
    assert (np.abs(want).reshape(-1, D).max(-1)[lost] == 0).all()
    assert (np.abs(y.detach().numpy()).reshape(-1, D).max(-1)[lost] == 0).all()


def test_routing_rules():
    """Ties go to the lower expert; slot j queues behind every earlier slot;
    the capacity drops the rest."""
    probs = torch.tensor([[0.4, 0.4, 0.2], [0.1, 0.5, 0.4], [0.3, 0.3, 0.4], [0.5, 0.3, 0.2]])
    experts = TM.route(probs, 2)
    assert experts.tolist() == [[0, 1], [1, 2], [2, 0], [0, 1]]
    slot, keep = TM.assign_slots(experts, 3, capacity=2)
    # slot 0: e0 <- tokens 0, 3; e1 <- 1; e2 <- 2. slot 1 behind them.
    assert slot.tolist() == [[0, 1], [0, 1], [0, 2], [1, 2]]
    assert keep.tolist() == [[True, True], [True, True], [True, False], [True, False]]
    assert TM.MoEMLP(8, 8, 8, top_k=2).capacity(16384) == 5120  # moe-dit64's b64


def test_moe_dit_matches_jax(twin):
    """tiny-moe's DiT (every block MoE, top-2): forward and the mean aux
    value over its layers, recorded in training mode."""
    cfg = TD.DiTConfig(**DIT)
    model = TD.DiT(cfg)
    model.load_state_dict(dit_state_dict_from_jax_params(twin["dparams"], cfg), strict=True)
    assert isinstance(model.block_0.moe, TM.MoEMLP) and not hasattr(model.block_0, "mlp_in")
    out = model.train()(torch.from_numpy(twin["xd"]), torch.from_numpy(twin["t"]))
    want, aux = twin["ref"][1]
    assert np.abs(want).max() > 0.1 and rel_err(out, want) <= REL_TOL
    got = TM.moe_aux_mean(model).detach()
    assert abs(float(got) - float(aux)) <= REL_TOL * abs(float(aux))
    TM.clear_moe_aux(model)
    assert TM.moe_aux_mean(model) is None
    with torch.no_grad():
        model.eval()(torch.from_numpy(twin["xd"]), torch.from_numpy(twin["t"]))
    assert TM.moe_aux_mean(model) is None  # sampling records nothing


def test_moe_every_interleave():
    cfg = TD.DiTConfig(**{**DIT, "depth": 4, "moe_every": 2})
    assert [cfg.block_experts(i) for i in range(4)] == [0, 4, 0, 4]
    model = TD.DiT(cfg)
    assert hasattr(model.block_0, "mlp_in") and hasattr(model.block_1, "moe")


def test_trainer_adds_the_load_balance_loss():
    """Trainer.loss = the process's loss + moe_aux_weight * the mean aux of
    the step's call(s), and the values are cleared after the step."""
    from eo_diffusion_torch.diffusion.flow import FlowMatching
    from eo_diffusion_torch.train.trainer import Trainer, TrainerConfig
    from eo_diffusion_torch.weights import randomize_parameters

    model = randomize_parameters(TD.DiT(TD.DiTConfig(**DIT)), 1)
    flow = FlowMatching.create(image_size=16, in_channels=3)
    tr = Trainer(TrainerConfig(batch_size=2, epochs=1, moe_aux_weight=0.5,
                                   preview_sampler="flow"), model, flow, 1,
                 device="cpu")
    state = tr.init()
    rng = np.random.default_rng(2)
    batch = {"image": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
             "noise": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
             "t": np.array([0.3, 0.8], np.float32)}
    state.model.train()
    loss = tr.loss(state, batch)
    assert TM.moe_aux_mean(state.model) is None  # cleared once the step's loss is formed
    fn = lambda x, t, c, y: state.model(x, t, cond=c, y=y)
    TM.clear_moe_aux(state.model)
    base = flow.train_loss(fn, torch.from_numpy(batch["image"]),
                           noise=torch.from_numpy(batch["noise"]),
                           t=torch.from_numpy(batch["t"]))
    aux = TM.moe_aux_mean(state.model)
    assert aux is not None and float(aux) > 0
    torch.testing.assert_close(loss, base + 0.5 * aux, rtol=1e-6, atol=0)
