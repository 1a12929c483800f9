"""The port's LR schedules and EMA against eo_diffusion_tpu (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.train import ema as TE
from eo_diffusion_torch.train import lr_schedules as TL
from eo_diffusion_tpu.train import ema as JE
from eo_diffusion_tpu.train import lr_schedules as JL


@pytest.mark.parametrize("lr,spe,epochs,warmup", [(1e-3, 7, 12, 10), (2e-4, 5, 3, 3),
                                                  (1e-3, 10, 1, 0)])
def test_warmup_cos_exp_table_equals_jax(lr, spe, epochs, warmup):
    n = spe * epochs
    got = TL.warmup_cos_exp(lr, spe, epochs, warmup_epochs=warmup).table(n)
    want = JL.warmup_cos_exp(lr, spe, epochs, warmup_epochs=warmup).table(n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_keyframes_percent_units_equal_jax():
    frames = [(0.0, 0.1), "cos", {"position": 0.25, "lr": 1.0}, (0.5, 0.5),
              {"transition": lambda last, s, e, pos, sch: last * 0.99},
              {"position": "end", "lr": 0.01}]
    got, want = (m.KeyframeSchedule(frames, end=40, units="percent") for m in (TL, JL))
    np.testing.assert_array_equal(got.table(40), want.table(40))
    assert got.sample_lrs(16) == want.sample_lrs(16)
    with pytest.raises(ValueError, match="out of order"):
        TL.KeyframeSchedule([(0.5, 1.0), (0.2, 0.1)], end=10)


def test_keyframes_time_units(monkeypatch):
    """"time" units read the wall clock: positions are fractions of the
    expected run time. Both packages see the same faked clock."""
    clock = {"now": 100.0}
    monkeypatch.setattr(TL, "_timer", lambda: clock["now"])
    monkeypatch.setattr(JL, "_timer", lambda: clock["now"])
    frames = [(0.0, 0.0), (0.5, 1.0), "cos", ("end", 0.2)]
    got, want = (m.KeyframeSchedule(frames, end=60.0, units="time") for m in (TL, JL))
    for now in (100.0, 115.0, 130.0, 150.0, 160.0, 200.0):
        clock["now"] = now
        assert got(0) == want(0)
        assert got.progress == want.progress == (now - 100.0) / 60.0
    assert got(0) == pytest.approx(0.2)  # past the end it holds the last LR
    with pytest.raises(ValueError, match="wall clock"):
        got.table(10)


def test_set_lr_indexes_by_optimizer_step_and_clips():
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(2))], lr=1.0)
    table = np.asarray([0.1, 0.2, 0.3], np.float32)
    assert [TL.set_lr(opt, table, s) for s in (-1, 0, 2, 7)] == [
        float(table[0]), float(table[0]), float(table[2]), float(table[2])]
    assert opt.param_groups[0]["lr"] == float(table[2])


def test_decay_values_equal_jax():
    for args in ((0.995, 128, 10, 100), (0.999, 8, 1, 400), (0.9, 512, 10, 1)):
        assert TE.adjusted_decay(*args) == JE.adjusted_decay(*args)
    for n in (0, 1, 9, 100, 10**6):
        want = float(JE.warmed_decay(0.995, jnp.asarray(n)))
        assert TE.warmed_decay(0.995, n) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ema_update_matches_jax_with_f32_arithmetic(dtype):
    rng = np.random.default_rng(0)
    e, p = (rng.normal(size=(33, 5)).astype(np.float32) for _ in range(2))
    want = JE.ema_update({"w": jnp.asarray(e, dtype)}, {"w": jnp.asarray(p)}, 0.9)["w"]
    shadow = [torch.from_numpy(e).to(getattr(torch, dtype))]
    TE.ema_update(shadow, [torch.from_numpy(p)], 0.9)
    assert shadow[0].dtype == getattr(torch, dtype)
    # f32: a fused multiply-add on one side is one ulp; bf16: equal after rounding
    np.testing.assert_allclose(shadow[0].float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-6 if dtype == "float32" else 0, atol=0)


def test_ema_cadence_is_step_mod_every_before_increment():
    ema, prm = [torch.zeros(3)], [torch.ones(3)]
    did = [TE.ema_update_every(ema, prm, 0.5, step, every=3) for step in range(7)]
    assert did == [True, False, False, True, False, False, True]
    assert torch.equal(ema[0], torch.full((3,), 1 - 0.5 ** 3))
