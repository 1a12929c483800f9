"""``cli.train --config`` and the profiler window of the port against the
JAX package on the CPU.

The same JSON gives the same parsed values in both parsers for the keys
both accept, a flag on the command line wins over the file, an unknown key
raises ``ValueError``, and a key whose flag the port still refuses (ROADMAP
queue 16) exits naming the queue, as the flag does. ``--profile_dir`` writes
a trace of ``--profile_steps`` training steps from the second step on (and
stops on an early exit too). ``utils.profiling.flops_of`` of a small matmul
and an unpadded convolution equals XLA's ``cost_analysis`` count (JAX
``utils.profiling.flops_of``: the file's one jitted JAX function)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eo_diffusion_torch.cli import train as TT
from eo_diffusion_torch.utils import profiling as TPF
from eo_diffusion_tpu.cli import train as JT
from torch_parity import one_torch_thread  # noqa: F401

FILE = {"lr": 0.002, "batch_size": 4, "epochs": 3, "preset": "tiny-sr", "optimizer": "muon",
        "muon_lr_mult": 0.5, "grad_clip": 1.0, "grad_accum": 2, "skip_nonfinite": True,
        "profile_dir": "prof", "profile_steps": 2, "dataset": "synthetic", "seed": 7,
        "class_dropout": 0.1, "tome_ratio": 0.25, "preview_sampler": "ddim",
        "model_ema_decay": 0.99, "posthoc_ema": True}


def _write(tmp_path, cfg):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("cli_lr", [None, "0.01"])
def test_the_same_json_parses_the_same_in_both(tmp_path, cli_lr):
    argv = ["--config", _write(tmp_path, FILE)]
    if cli_lr:
        argv = ["--lr", cli_lr, *argv]
    got, want = TT.parse_args(argv), JT.parse_args(argv)
    both = sorted(set(vars(got)) & set(vars(want)))
    assert set(FILE) <= set(both)
    assert {k: getattr(got, k) for k in both} == {k: getattr(want, k) for k in both}
    assert got.lr == (float(cli_lr) if cli_lr else FILE["lr"])
    assert got.optimizer == "muon" and got.profile_steps == 2


def test_unknown_and_refused_keys(tmp_path, capsys):
    for mod in (TT, JT):
        with pytest.raises(ValueError, match="unknown config key 'no_such_flag'"):
            mod.parse_args(["--config", _write(tmp_path, {"no_such_flag": 1})])
    for key in ("fsdp", "model_parallel", "pp_micro"):
        with pytest.raises(SystemExit) as exc:
            TT.parse_args(["--config", _write(tmp_path, {"lr": 0.1, key: 2})])
        assert exc.value.code == 2 and "ROADMAP queue 16" in capsys.readouterr().err
        # the JAX CLI takes the key
        assert getattr(JT.parse_args(["--config", _write(tmp_path, {key: 2})]), key) == 2


def _spans(path):
    events = json.load(open(path))["traceEvents"]
    return [e for e in events if e.get("name") == TPF.STEP_SPAN and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("steps,window,captured", [(5, 2, 2), (3, 5, 2)])
def test_profile_window(tmp_path, monkeypatch, steps, window, captured):
    """The window opens after the first step and spans --profile_steps
    steps; a run that ends inside it closes it with what it captured."""
    monkeypatch.chdir(tmp_path)
    res = TT.main(TT.parse_args([
        "--preset", "tiny", "--dataset", "synthetic", "--device", "cpu", "--batch_size", "4",
        "--epochs", "1", "--steps_per_epoch", str(steps), "--sample_every", "0",
        "--save_every", "0", "--dir", "results/p", "--profile_dir", str(tmp_path / "prof"),
        "--profile_steps", str(window)]))
    assert res["steps"] == steps and res["profile"]["steps"] == captured
    trace = tmp_path / "prof" / TPF.TRACE_FILE
    assert res["profile"]["trace"] == str(trace) and trace.is_file()
    assert len(_spans(trace)) == captured


def test_no_profile_dir_writes_no_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = TT.main(TT.parse_args([
        "--preset", "tiny", "--dataset", "synthetic", "--device", "cpu", "--batch_size", "4",
        "--epochs", "1", "--steps_per_epoch", "2", "--sample_every", "0", "--save_every", "0",
        "--dir", "results/p"]))
    assert res["profile"] == {"trace": None, "steps": 0}


def test_flops_of_equals_xla_cost_analysis():
    from eo_diffusion_tpu.utils.profiling import flops_of as jflops

    import jax

    def jfn(a, b, x, w):
        # VALID: for a padded conv XLA counts only the taps that land on the
        # image, FlopCounterMode every tap
        y = jax.lax.conv_general_dilated(x, w, (1, 1), "VALID",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return a @ b, y

    shapes = ((16, 32), (32, 8), (2, 8, 8, 4), (3, 3, 4, 6))
    want = jflops(jfn, *(jnp.ones(s, jnp.float32) for s in shapes))

    def tfn(a, b, x, w):
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
        return a @ b, y

    got = TPF.flops_of(tfn, *(torch.ones(s) for s in shapes))
    assert got == want == 2 * 16 * 32 * 8 + 2 * 2 * 6 * 6 * 6 * 3 * 3 * 4


def test_step_timer_and_sync(tmp_path):
    timer = TPF.StepTimer(flops_per_step=2e12, window=2)
    for _ in range(3):
        with timer.step(torch.ones(2)):
            pass
    assert len(timer.times) == 2
    s = timer.summary()
    assert set(s) == {"step_time_s", "steps_per_sec", "tflops_per_sec", "mfu"}
    assert s["mfu"] == pytest.approx(s["tflops_per_sec"] * 1e12 / 989e12)
    TPF.sync({"x": torch.ones(1)})
    TPF.sync()
    with TPF.trace(str(tmp_path / "prof")) as cap:
        torch.ones(4).sum()
    assert (tmp_path / "prof" / TPF.TRACE_FILE).is_file() and cap.path.endswith(TPF.TRACE_FILE)
    assert np.isfinite(TPF.PEAK_FLOPS)
