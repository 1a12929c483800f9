"""The port's exported artifact (``serving/export.py``,
``serving/artifact_server.py``, ``cli/export_model.py``) on the CPU: the
artifact returns the live engine's bytes for a seed, loads in a fresh
process that imports no model, sampler, CLI or JAX module, holds the
``eo::`` kernel ops, and covers the concat, class-conditional, flow,
MeanFlow-1 and int8 engines. No JAX here: the engine's own parity with the
JAX samplers is ``tests/test_torch_serving.py``'s."""

import base64
import io
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from eo_diffusion_torch.cli import serve as serve_cli
from eo_diffusion_torch.serving.export import MAX_EXPORT_CALLS, export_engine, load_model
from eo_diffusion_torch.weights import randomize_parameters
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# what a deployment host must not need
FORBIDDEN = ("jax", "eo_diffusion_tpu", "eo_diffusion_torch.models",
             "eo_diffusion_torch.diffusion", "eo_diffusion_torch.cli")


def _engine(*argv, seed=0):
    """An engine of ``cli.serve`` (CPU, float32, batch 2) with seeded random
    weights (a fresh init zeroes every output layer)."""
    engine, batcher, meta = serve_cli.build_engine(serve_cli.parse_args(
        list(argv) + ["--batch_size", "2", "--no_bf16", "--device", "cpu"]))
    batcher.shutdown()
    randomize_parameters(engine.model, seed)
    engine.swap_params(dict(engine.model.named_parameters()))
    return engine, meta


@pytest.fixture(scope="module")
def concat_artifact(tmp_path_factory):
    """tiny-cr DDIM-5, exported, and loaded once by the artifact server's
    engine."""
    from eo_diffusion_torch.serving.artifact_server import ArtifactEngine

    engine, meta = _engine("--preset", "tiny-cr", "--sampler_steps", "5")
    out = str(tmp_path_factory.mktemp("art") / "cr")
    manifest = export_engine(engine, out, extra_meta=meta)
    return engine, manifest, out, ArtifactEngine(out)


def test_artifact_in_a_fresh_process_is_the_live_engines_bytes(concat_artifact, tmp_path):
    engine, manifest, out, _ = concat_artifact
    for name in ("sampler.pt2", "params.npz", "manifest.json"):
        assert os.path.exists(os.path.join(out, name)), name
    assert manifest["format"] == "eo_diffusion_torch.export/1"
    assert manifest["n_leaves"] == len(engine.names) and manifest["device"] == "cpu"
    assert manifest["artifact_bytes"] > manifest["param_bytes"] > 0
    cond = np.random.default_rng(0).uniform(-1, 1, size=(2, 8, 8, 3)).astype(np.float32)
    np.save(tmp_path / "cond.npy", cond)
    script = f"""
import sys, json, numpy as np
from eo_diffusion_torch.serving.export import load_model
generate, man = load_model({out!r})
np.save({str(tmp_path / 'got.npy')!r}, generate(11, cond=np.load({str(tmp_path / 'cond.npy')!r})))
print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'jax'
                        or m.startswith({FORBIDDEN!r}))))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []  # no model code loaded
    got = np.load(tmp_path / "got.npy")
    np.testing.assert_array_equal(got, engine.generate(11, None, cond))
    assert not np.array_equal(got, engine.generate(12, None, cond))


def test_the_graph_holds_the_kernel_ops(concat_artifact):
    """The saved program's graph (listed in the manifest as it was saved)
    calls the eo:: ops."""
    engine, manifest, out, loaded = concat_artifact
    assert manifest["eo_ops"] == ["eo.group_norm.default", "eo.qkv_attention.default"]
    assert manifest["graph_nodes"] > 1000 and manifest["model_calls"] == 5
    assert manifest["param_bytes"] == sum(p.numel() * 4 for p in engine.model.parameters())
    with pytest.raises(AssertionError):
        loaded.generate(0, cond=np.zeros((2, 4, 4, 3), np.float32))  # wrong shape
    with pytest.raises(AssertionError):
        loaded.generate(0, y=[0, 0])  # not class-conditional


@pytest.mark.parametrize("case,argv", [
    ("label-cfg", ("--preset", "tiny-cddpm", "--num_classes", "5", "--class_dropout", "0.15",
                   "--guidance_scale", "2", "--sampler_steps", "2")),
    ("flow", ("--preset", "tiny-flow", "--sampler_steps", "2")),
    ("meanflow-1", ("--preset", "tiny-meanflow", "--sampler_steps", "1")),
    ("int8", ("--preset", "tiny", "--sampler_steps", "2", "--int8", "--eta", "1")),
])
def test_artifacts_match_their_live_engines(case, argv, tmp_path):
    engine, meta = _engine(*argv)
    manifest = export_engine(engine, str(tmp_path / case), extra_meta=meta)
    generate, man = load_model(str(tmp_path / case))
    y = np.array([4, 1]) if case == "label-cfg" else None
    np.testing.assert_array_equal(generate(5, y=y), engine.generate(5, y, None))
    if case == "label-cfg":
        assert man["num_classes"] == 5
        assert not np.array_equal(generate(5, y=[0, 0]), generate(5, y=[2, 3]))
        with pytest.raises(AssertionError):
            generate(0, y=[0, 9])  # out of vocabulary
    if case == "int8":
        z = np.load(os.path.join(str(tmp_path / case), "params.npz"))
        assert man["int8"] and any(z[k].dtype == np.int8 for k in z.files)
        assert man["n_leaves"] == 2 * len(engine.names)
        # DDIM at eta 1: one noise a step, drawn by the loader as the engine does
        assert man["noise_draws"] == 2
    assert manifest["model_calls"] == {"label-cfg": 2, "flow": 2, "meanflow-1": 1,
                                       "int8": 2}[case]


def test_a_long_chain_is_refused(tmp_path):
    engine, _ = _engine("--preset", "tiny", "--sampler", "ddpm", "--timesteps",
                        str(MAX_EXPORT_CALLS + 50))
    with pytest.raises(ValueError, match="ROADMAP queue 1, item 18"):
        export_engine(engine, str(tmp_path / "ddpm"))


def test_cli_export_model_run(tmp_path):
    from eo_diffusion_torch.cli import export_model as M

    out = str(tmp_path / "art")
    res = M.main(M.parse_args(["--preset", "tiny", "--out", out, "--batch_size", "2",
                               "--sampler_steps", "2", "--no_bf16", "--device", "cpu",
                               "--run", "--seed", "3"]))
    assert os.path.exists(os.path.join(out, "smoke.png"))
    assert res["samples"].shape == (2, 8, 8, 3) and np.isfinite(res["samples"]).all()
    assert res["preset"] == "tiny" and res["load_seconds"] > 0
    # the CLI's engine is cli.serve's, from the same seeded fresh init
    engine, batcher, _ = serve_cli.build_engine(serve_cli.parse_args(
        ["--preset", "tiny", "--batch_size", "2", "--sampler_steps", "2", "--no_bf16",
         "--device", "cpu"]))
    batcher.shutdown()
    np.testing.assert_array_equal(res["samples"], engine.generate(3))


def test_artifact_server_round_trip(concat_artifact):
    from eo_diffusion_torch.serving.artifact_server import make_server

    engine, _, out, loaded = concat_artifact
    srv, port = make_server(out, port=0, engine=loaded)
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{port}"
    cond = np.random.default_rng(1).normal(size=(1, 8, 8, 3)).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, cond)

    def post(payload):
        req = urllib.request.Request(url + "/v1/generate", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["manifest"]["sampler"] == "ddim"
        code, resp = post({"n": 1, "seed": 7,
                           "cond_b64": base64.b64encode(buf.getvalue()).decode()})
        assert code == 200 and resp["shape"] == [1, 8, 8, 3]
        got = np.load(io.BytesIO(base64.b64decode(resp["npy_b64"])), allow_pickle=False)
        full = np.concatenate([cond, np.zeros((1, 8, 8, 3), np.float32)])
        np.testing.assert_array_equal(got, engine.generate(7, None, full)[:1])
        assert post({"n": 3, "seed": 1})[0] == 400  # above the artifact's batch
    finally:
        srv.shutdown()
