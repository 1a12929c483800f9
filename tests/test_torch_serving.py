"""The port's serving subsystem (``eo_diffusion_torch/serving``,
``cli/serve.py``) on the CPU: the batcher's semantics over a stand-in engine
(JAX ``tests/test_serving.py``'s ``TestBatching``, pure Python), the engine's
program against the JAX package's sampler calls of the same configuration
from one start noise (tiny-cr DDIM-10, tiny-cddpm label-CFG, tiny-flow Heun,
tiny-bridge, tiny-meanflow 1 step; ``TOL_TRAJ``), the build-time checks,
the HTTP API, ``cli.serve``'s preset forcing and ``--int8``. The JAX side
runs its samplers un-jitted: each compiles its own scan."""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.cli import serve as serve_cli
from eo_diffusion_torch.serving.engine import BatchingEngine, SamplerEngine, ServingConfig
from eo_diffusion_torch.serving import seeding
from eo_diffusion_torch.weights import randomize_parameters
from torch_parity import fill_params, one_torch_thread, rel_err  # noqa: F401

# a whole sampler trajectory against the JAX package's (PERF.md §2)
TOL_TRAJ = 5e-5


class _FakeEngine:
    """Stands in for SamplerEngine: rows carry (batch index, row index) and
    the seed's last digits, so the tests see packing and routing without a
    model."""

    def __init__(self, batch_size=8, num_classes=0, cond_channels=0, delay=0.0):
        self.cfg = ServingConfig(batch_size=batch_size, num_classes=num_classes,
                                 cond_channels=cond_channels, batch_window_ms=60.0,
                                 request_timeout_s=20.0)
        self.image_size = 4
        self.calls = []  # (y, cond) per device batch
        self.delay = delay

    @property
    def batch_size(self):
        return self.cfg.batch_size

    def _blank_cond(self):
        if not self.cfg.cond_channels:
            return None
        return np.zeros((self.cfg.batch_size, 4, 4, self.cfg.cond_channels), np.float32)

    def generate(self, seed, y, cond):
        if self.delay:
            time.sleep(self.delay)
        b = len(self.calls)
        self.calls.append((None if y is None else y.copy(),
                           None if cond is None else cond.copy()))
        out = np.zeros((self.batch_size, 4, 4, 1), np.float32)
        out[:, 0, 0, 0] = b
        out[:, 0, 1, 0] = np.arange(self.batch_size)
        out[:, 0, 2, 0] = float(seed % 1000)  # the seed reaches the engine
        return out


class TestBatching:
    def test_concurrent_requests_coalesce(self):
        eng = _FakeEngine(batch_size=8)
        batcher = BatchingEngine(eng)
        results = {}

        def ask(name, n):
            results[name] = batcher.submit(n)

        ts = [threading.Thread(target=ask, args=(f"r{i}", 2)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        batcher.shutdown()
        assert len(eng.calls) == 1  # 3x2 rows fit one 8-row batch
        rows = sorted(int(results[f"r{i}"][j][0, 1, 0]) for i in range(3) for j in range(2))
        assert rows == [0, 1, 2, 3, 4, 5]  # distinct, contiguous packing
        st = batcher.stats()
        assert st["requests"] == 3 and st["images"] == 6 and st["batches"] == 1

    def test_overflow_rolls_to_next_batch(self):
        eng = _FakeEngine(batch_size=4)
        batcher = BatchingEngine(eng)
        out = []
        ts = [threading.Thread(target=lambda: out.append(batcher.submit(3))) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        batcher.shutdown()
        assert len(eng.calls) == 2  # 3+3 can't share a 4-row batch
        assert [r.shape[0] for r in out] == [3, 3]

    def test_seeded_requests_run_solo_and_reproduce(self):
        eng = _FakeEngine(batch_size=8)
        batcher = BatchingEngine(eng)
        a = batcher.submit(1, seed=123)
        b = batcher.submit(1, seed=123)
        c = batcher.submit(1)  # unseeded: a seed of the base seed and the batch
        batcher.shutdown()
        assert len(eng.calls) == 3
        assert a[0, 0, 2, 0] == b[0, 0, 2, 0] == 123
        assert c[0, 0, 2, 0] == seeding.chunk_seed(0, 2) % 1000

    @pytest.mark.parametrize("bad", [[7], [-1]])
    def test_label_routing_and_validation(self, bad):
        eng = _FakeEngine(batch_size=6, num_classes=3)
        batcher = BatchingEngine(eng)
        r = batcher.submit(2, y=[2, 1])
        assert r.shape[0] == 2
        with pytest.raises(AssertionError, match="out of vocabulary"):
            batcher.submit(1, y=bad)  # a negative label too
        with pytest.raises(AssertionError, match="max_request"):
            batcher.submit(eng.cfg.max_request + 1)
        batcher.shutdown()
        y0 = eng.calls[0][0]
        assert list(y0[:2]) == [2, 1] and list(y0[2:]) == [0] * 4  # padded

    def test_large_request_streams_over_batches(self):
        eng = _FakeEngine(batch_size=4, num_classes=12)
        batcher = BatchingEngine(eng)
        labels = list(range(10))
        out = batcher.submit(10, y=labels)
        batcher.shutdown()
        assert out.shape[0] == 10 and len(eng.calls) == 3  # 4 + 4 + 2
        routed = np.concatenate([eng.calls[0][0], eng.calls[1][0], eng.calls[2][0][:2]])
        assert list(routed) == labels
        assert [int(out[i][0, 0, 0]) for i in (0, 4, 8)] == [0, 1, 2]
        assert [int(out[i][0, 1, 0]) for i in (0, 5, 9)] == [0, 1, 1]
        st = batcher.stats()
        assert st["images"] == 10 and st["batches"] == 3

    def test_seeded_stream_reproduces_and_prefixes(self):
        """A seeded n > B request is reproducible, and its first chunk uses
        the plain seed: the bytes an n <= B request gets."""
        eng = _FakeEngine(batch_size=4)
        batcher = BatchingEngine(eng)
        a = batcher.submit(10, seed=123)
        b = batcher.submit(10, seed=123)
        solo = batcher.submit(4, seed=123)
        batcher.shutdown()
        np.testing.assert_array_equal(a[:, 0, 2, 0], b[:, 0, 2, 0])
        assert a[0, 0, 2, 0] == solo[0, 0, 2, 0] == 123
        assert a[4, 0, 2, 0] == seeding.chunk_seed(123, 1) % 1000 != a[0, 0, 2, 0]

    def test_engine_error_propagates(self):
        eng = _FakeEngine(batch_size=4)

        def boom(seed, y, cond):
            raise RuntimeError("device on fire")

        eng.generate = boom
        batcher = BatchingEngine(eng)
        with pytest.raises(RuntimeError, match="device on fire"):
            batcher.submit(1)
        batcher.shutdown()

    def test_submit_iter_yields_progressively(self):
        eng = _FakeEngine(batch_size=4, delay=0.15)
        batcher = BatchingEngine(eng)
        t0 = time.time()
        it = batcher.submit_iter(12, seed=5)  # 3 chunks x 0.15 s
        first = next(it)
        t_first = time.time() - t0
        rest = list(it)
        t_all = time.time() - t0
        assert first.shape[0] == 4 and len(rest) == 2
        assert t_first < t_all - 0.2, (t_first, t_all)
        streamed = np.concatenate([first] + rest, axis=0)
        ref = batcher.submit(12, seed=5)
        batcher.shutdown()
        np.testing.assert_array_equal(streamed[:, 0, 2, 0], ref[:, 0, 2, 0])

    def test_submit_iter_error_surfaces_at_failing_chunk(self):
        eng = _FakeEngine(batch_size=4)
        calls = []

        def boom(seed, y, cond):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError("device on fire")
            return np.zeros((4, 4, 4, 1), np.float32)

        eng.generate = boom
        batcher = BatchingEngine(eng)
        it = batcher.submit_iter(8, seed=3)
        assert next(it).shape[0] == 4  # chunk 0 succeeds
        with pytest.raises(RuntimeError, match="device on fire"):
            next(it)
        batcher.shutdown()

    def test_shutdown_fails_leftovers(self):
        """A request queued behind the shutdown fails instead of hanging."""
        eng = _FakeEngine(batch_size=1, delay=0.4)
        batcher = BatchingEngine(eng)
        done, errors = [], []

        def ask():
            try:
                done.append(batcher.submit(1))
            except RuntimeError as e:
                errors.append(str(e))

        first = threading.Thread(target=ask)
        first.start()
        time.sleep(0.1)  # the worker is inside the first batch
        stop = threading.Thread(target=batcher.shutdown)
        stop.start()
        time.sleep(0.05)
        late = threading.Thread(target=ask)
        late.start()
        for t in (first, stop, late):
            t.join()
        assert len(done) == 1 and errors == ["serving engine shut down"]


# -- the engine's program against the JAX package's sampler calls ---------------

B = 2


def _twin(name, num_classes=0, class_dropout=0.0, cond=False):
    """The JAX model, params and process of preset ``name``, and the port's
    model (the same seeded weights) and process."""
    from eo_diffusion_torch.cli import presets as TP
    from eo_diffusion_torch.weights import backbone_state_dict_from_jax_params
    from eo_diffusion_tpu.cli import presets as JPR
    from eo_diffusion_tpu.models import time_template

    jp, tp = JPR.get_preset(name), TP.get_preset(name)
    cc = jp.in_channels if cond else 0
    kw = dict(bf16=False, cond_channels=cc, num_classes=num_classes or None,
              class_dropout_prob=class_dropout)
    jcfg, tcfg = jp.model_config(**kw), tp.model_config(**kw)
    jmodel = JPR.build_denoiser(jcfg)
    s = jp.image_size
    init_kw = {"cond": jnp.zeros((1, s, s, cc))} if cc else {}
    if num_classes:
        init_kw["y"] = jnp.zeros((1,), jnp.int32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)),
                            time_template(jmodel), **init_kw)
    params = fill_params(shapes, seed=11)
    model = TP.build_denoiser(tcfg)
    model.load_state_dict(backbone_state_dict_from_jax_params(params, tcfg), strict=True)
    ctype = "concat" if cond else None
    return (jmodel, params, JPR.build_process(jp, 50, s, cond_type=ctype), model.eval(),
            TP.build_process(tp, 50, s, cond_type=ctype))


CASES = {
    # name: (twin kwargs, ServingConfig fields)
    "tiny-cr-ddim10": (dict(name="tiny-cr", cond=True), dict(sampler="ddim", steps=10)),
    "tiny-cddpm-label-cfg": (dict(name="tiny-cddpm", num_classes=5, class_dropout=0.15),
                             dict(sampler="ddim", steps=5, num_classes=5, has_null_class=True,
                                  guidance_scale=3.0)),
    "tiny-flow-heun": (dict(name="tiny-flow"), dict(sampler="flow", steps=3,
                                                    flow_method="heun")),
    "tiny-bridge": (dict(name="tiny-bridge", cond=True), dict(sampler="bridge", steps=3)),
    "tiny-meanflow-1": (dict(name="tiny-meanflow"), dict(sampler="flow", steps=1)),
}


def _jax_sample(cfg, jmodel, params, jdiff, x_T, y, cond):
    """The JAX engine's sampler call (``serving/engine.py`` ``run``) with
    ``x_T`` given."""
    fn = lambda x, t, c, yy: jmodel.apply(params, x, t, cond=c, y=yy)
    kw, rng = {}, jax.random.PRNGKey(0)
    if cfg.guidance_scale != 1.0:
        kw = dict(guidance_scale=cfg.guidance_scale,
                  y_uncond=jnp.full((B,), cfg.num_classes, jnp.int32))
    if cfg.sampler == "flow":
        out = jdiff.sample(fn, rng, B, num_steps=cfg.steps, method=cfg.flow_method, cond=cond,
                           y=y, dtype=jnp.float32, x_T=x_T, **kw)
    elif cfg.sampler == "bridge":
        out = jdiff.sample(fn, rng, B, num_steps=cfg.steps, cond=cond, y=y,
                           dtype=jnp.float32, eta=cfg.eta)
    else:
        out = jdiff.ddim_sample(fn, rng, B, num_steps=cfg.steps, eta=cfg.eta,
                                method=cfg.ddim_spacing, cond=cond, y=y, dtype=jnp.float32,
                                x_T=x_T, **kw)
    return np.asarray(out.x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_program_matches_jax_sampler(case):
    twin_kw, fields = CASES[case]
    jmodel, params, jdiff, model, tdiff = _twin(**twin_kw)
    cfg = ServingConfig(batch_size=B, bf16=False,
                        cond_channels=3 if twin_kw.get("cond") else 0, **fields)
    engine = SamplerEngine(model, None, tdiff, 8, 3, cfg)
    assert engine.count_draws() == (0, {"tiny-cr-ddim10": 10, "tiny-cddpm-label-cfg": 5,
                                        "tiny-flow-heun": 5, "tiny-bridge": 3,
                                        "tiny-meanflow-1": 1}[case])
    rng = np.random.default_rng(3)
    x_T = rng.normal(size=(B, 8, 8, 3)).astype(np.float32)
    cond = (rng.uniform(-1, 1, size=(B, 8, 8, 3)).astype(np.float32)
            if cfg.cond_channels else None)
    y = np.array([1, 4]) if cfg.num_classes else None
    want = _jax_sample(cfg, jmodel, params, jdiff, jnp.asarray(x_T),
                       None if y is None else jnp.asarray(y, jnp.int32),
                       None if cond is None else jnp.asarray(cond))
    y_t, c_t = engine._inputs(y, cond)
    got = engine._run(engine.leaves(), torch.from_numpy(x_T), None, y_t, c_t)
    assert got.shape == (B, 8, 8, 3) and np.isfinite(want).all()
    assert rel_err(got, want) <= TOL_TRAJ


def _tiny_engine(cfg, name="tiny", cond=False):
    from eo_diffusion_torch.cli import presets as TP

    p = TP.get_preset(name)
    model = randomize_parameters(
        TP.build_denoiser(p.model_config(bf16=False, cond_channels=3 if cond else 0)), 0)
    return SamplerEngine(model, None, TP.build_process(p, 50, 8, "concat" if cond else None),
                         8, 3, cfg)


def test_guidance_without_cfg_branch_and_misplaced_knobs_are_refused():
    for cfg, match in (
            (ServingConfig(batch_size=2, sampler="ddpm", bf16=False, cond_channels=3,
                           guidance_scale=2.0), "CFG branch"),
            (ServingConfig(batch_size=2, steps=2, bf16=False, num_classes=10,
                           guidance_scale=2.0), "CFG branch"),
            (ServingConfig(batch_size=2, sampler="bridge", steps=2, bf16=False,
                           cond_channels=3, guidance_scale=2.0), "CFG branch"),
            (ServingConfig(batch_size=2, sampler="bridge", steps=2, bf16=False,
                           pag_scale=2.0), "pag_scale"),
            (ServingConfig(batch_size=2, sampler="flow", steps=2, bf16=False,
                           dynamic_threshold=0.995), "dynamic_threshold")):
        with pytest.raises(AssertionError, match=match):
            _tiny_engine(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 16"):
        _tiny_engine(ServingConfig(batch_size=2, bf16=False, dp=True))


def test_guidance_knobs_pag_and_threshold_serve():
    """CFG rescale and interval on image-CFG, PAG (which shifts the output)
    and dynamic thresholding build and sample finite batches."""
    eng = _tiny_engine(ServingConfig(batch_size=2, steps=2, bf16=False, cond_channels=3,
                                     guidance_scale=2.0, guidance_rescale=0.7,
                                     guidance_interval=(0.1, 0.9)), "tiny-cr", cond=True)
    assert np.isfinite(eng.generate(1, None, np.ones((2, 8, 8, 3), np.float32))).all()
    plain = _tiny_engine(ServingConfig(batch_size=2, steps=2, bf16=False)).generate(1)
    pag_eng = _tiny_engine(ServingConfig(batch_size=2, steps=2, bf16=False, pag_scale=2.0))
    assert pag_eng.count_draws() == (0, 4)
    pag = pag_eng.generate(1)
    assert np.isfinite(pag).all() and not np.allclose(plain, pag, atol=1e-5)
    dt = _tiny_engine(ServingConfig(batch_size=2, steps=2, bf16=False,
                                    dynamic_threshold=0.995)).generate(1)
    assert np.isfinite(dt).all()


def test_seeded_draws_are_the_seedings():
    """generate(seed) equals the program fed seeding.draws' noises (DDIM with
    eta draws one noise a step), and ``warmup`` returns its seconds."""
    eng = _tiny_engine(ServingConfig(batch_size=2, steps=5, eta=1.0, bf16=False))
    draws, calls = eng.count_draws()
    assert (draws, calls) == (5, 5)
    x_T, noise = seeding.draws(9, eng.grid, draws, "cpu")
    fed = eng._run(eng.leaves(), x_T, noise, None, None).numpy()
    np.testing.assert_array_equal(eng.generate(9), fed)
    assert not np.array_equal(eng.generate(10), fed)
    assert eng.warmup() > 0


# -- the HTTP API -------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    args = serve_cli.parse_args(["--preset", "tiny", "--batch_size", "4", "--sampler", "ddim",
                                 "--sampler_steps", "2", "--no_bf16", "--device", "cpu",
                                 "--batch_window_ms", "30"])
    engine, batcher, meta = serve_cli.build_engine(args)
    randomize_parameters(engine.model, 1)
    engine.swap_params(dict(engine.model.named_parameters()))
    from eo_diffusion_torch.serving.http import make_server, serve_forever

    srv, port = make_server(batcher, meta, port=0, reload_fn=serve_cli.reload_fn(engine))
    serve_forever(srv, background=True)
    yield engine, batcher, f"http://127.0.0.1:{port}"
    srv.shutdown()
    batcher.shutdown()


def _post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npy(s):
    return np.load(io.BytesIO(base64.b64decode(s)), allow_pickle=False)


def test_http_healthz_stats_png_and_npy(served):
    import PIL.Image

    engine, _, url = served
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert h["ok"] and h["sampler"] == "ddim" and h["data_range"] == [0.0, 1.0]
    code, resp = _post(url, "/v1/generate", {"n": 2, "seed": 5})
    assert code == 200 and len(resp["images"]) == 2
    assert PIL.Image.open(io.BytesIO(base64.b64decode(resp["images"][0]))).size == (8, 8)
    code, resp = _post(url, "/v1/generate", {"n": 1, "format": "npy", "seed": 5})
    arr = _npy(resp["npy_b64"])
    assert code == 200 and arr.shape == (1, 8, 8, 3)
    np.testing.assert_array_equal(arr, engine.generate(5)[:1])  # the seed's bytes
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        st = json.loads(r.read())
    assert st["batch_size"] == 4 and st["batches"] >= 2 and st["latency_ms_p50"] > 0


def test_http_bad_requests_are_400(served):
    _, _, url = served
    code, resp = _post(url, "/v1/generate", {"n": 2000})
    assert code == 400 and "max_request" in resp["error"]
    assert _post(url, "/v1/generate", {"n": 1, "y": [0]})[0] == 400  # unconditional
    req = urllib.request.Request(url + "/v1/generate_stream",
                                 data=json.dumps({"n": 2000}).encode(),
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    assert _post(url, "/v1/reload", {})[0] == 400
    assert _post(url, "/v1/reload", {"ckpt": "/nonexistent/ckpt"})[0] == 500


def test_http_stream_ndjson(served):
    """n > B over /v1/generate_stream: one line a device batch and the done
    line; the chunks are /v1/generate's bytes for the seed."""
    _, _, url = served
    req = urllib.request.Request(url + "/v1/generate_stream",
                                 data=json.dumps({"n": 6, "seed": 9, "format": "npy"}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers.get("Content-Type") == "application/x-ndjson"
        lines = [json.loads(raw) for raw in r]
    assert [ln.get("chunk") for ln in lines[:-1]] == [0, 1]  # B=4: 4+2
    assert lines[-1] == {"done": True, "images_total": 6}
    streamed = np.concatenate([_npy(ln["npy_b64"]) for ln in lines[:-1]])
    code, resp = _post(url, "/v1/generate", {"n": 6, "seed": 9, "format": "npy"})
    np.testing.assert_array_equal(streamed, _npy(resp["npy_b64"]))
    solo = _npy(_post(url, "/v1/generate", {"n": 4, "seed": 9, "format": "npy"})[1]["npy_b64"])
    np.testing.assert_array_equal(streamed[:4], solo)  # chunk 0 = the solo request


def test_http_reload_changes_the_output(served, tmp_path):
    """/v1/reload from a checkpoint file, then from a checkpoint directory
    (its latest step), serves the EMA slot; the original weights give the
    original bytes again."""
    from eo_diffusion_torch.train.checkpoint import save_checkpoint

    engine, batcher, url = served
    before = batcher.submit(1, seed=3)
    sd = {k: v.detach().clone() for k, v in engine.model.named_parameters()}
    alt = {k: v + 0.05 for k, v in sd.items()}
    path = save_checkpoint(str(tmp_path), {"model": sd, "model_ema": alt}, name="alt")
    save_checkpoint(str(tmp_path / "run"), {"model": sd, "model_ema": sd}, step=1)
    save_checkpoint(str(tmp_path / "run"), {"model": sd, "model_ema": alt}, step=2)
    try:
        code, resp = _post(url, "/v1/reload", {"ckpt": path})
        assert code == 200 and resp["ok"] and resp["ckpt"] == path
        after = batcher.submit(1, seed=3)
        assert not np.array_equal(before, after)  # the EMA slot is served
        engine.swap_params(sd)
        assert _post(url, "/v1/reload", {"ckpt": str(tmp_path / "run")})[0] == 200
        np.testing.assert_array_equal(batcher.submit(1, seed=3), after)  # steps_2's EMA
    finally:
        engine.swap_params(sd)
    np.testing.assert_array_equal(batcher.submit(1, seed=3), before)


# -- cli.serve ---------------------------------------------------------------------


def _build(*argv):
    return serve_cli.build_engine(serve_cli.parse_args(
        list(argv) + ["--batch_size", "2", "--no_bf16", "--device", "cpu"]))


def test_serve_cli_forces_the_native_samplers():
    engine, batcher, meta = _build("--preset", "tiny-bridge", "--sampler_steps", "3")
    try:
        assert meta["sampler"] == "bridge" and meta["cond_channels"] == 3
        out = batcher.submit(1, cond=np.full((1, 8, 8, 3), 0.25, np.float32))
        assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    finally:
        batcher.shutdown()
    with pytest.raises(AssertionError, match="CFG"):
        _build("--preset", "tiny-bridge", "--guidance_scale", "2.0")
    engine, batcher, meta = _build("--preset", "tiny-flow", "--sampler_steps", "2")
    batcher.shutdown()
    assert meta["sampler"] == "flow" and engine.cfg.sampler == "flow"
    engine, batcher, meta = _build("--preset", "tiny-meanflow", "--sampler_steps", "1",
                                   "--flow_method", "heun")
    try:
        assert meta["sampler"] == "flow" and engine.cfg.flow_method == "euler"
        assert engine.count_draws() == (0, 1)
        assert np.isfinite(batcher.submit(1)).all()
    finally:
        batcher.shutdown()


def test_serve_cli_cond_type_none_and_refusals(capsys):
    engine, batcher, meta = _build("--preset", "tiny", "--cond_type", "none",
                                   "--sampler_steps", "2")
    batcher.shutdown()
    assert engine.cfg.cond_channels == 0 and meta["data_range"] == (0.0, 1.0)
    with pytest.raises(AssertionError, match="RePaint"):
        _build("--preset", "clouds64-attn")  # "sum" by default, no override
    with pytest.raises(SystemExit) as exc:
        serve_cli.parse_args(["--preset", "tiny", "--dp"])
    assert exc.value.code == 2 and "ROADMAP queue 16" in capsys.readouterr().err


def test_serve_cli_latent_preset_with_ae_ckpt(tmp_path):
    from eo_diffusion_torch.cli.presets import get_preset
    from eo_diffusion_torch.models.autoencoder import ConvAutoencoder
    from eo_diffusion_torch.train.ae_trainer import save_ae

    acfg = get_preset("tiny-latent-cr").ae_config()
    ae_dir = save_ae(str(tmp_path / "ae"), acfg, ConvAutoencoder(acfg), 1.0)
    with pytest.raises(AssertionError, match="first stage"):
        _build("--preset", "tiny-latent-cr", "--sampler_steps", "2")
    engine, batcher, meta = _build("--preset", "tiny-latent-cr", "--ae_ckpt", ae_dir,
                                   "--sampler_steps", "2")
    try:
        assert meta["cond_channels"] == 3 and engine.grid == (2, 4, 4, 4)
        out = batcher.submit(1, cond=np.zeros((1, 16, 16, 3), np.float32))
        assert out.shape == (1, 16, 16, 3) and np.isfinite(out).all()  # decoded pixels
        with pytest.raises(AssertionError):
            batcher.submit(1, cond=np.zeros((1, 4, 4, 3), np.float32))
    finally:
        batcher.shutdown()


def test_int8_serves_close_to_float():
    """--int8 (W8A16) packs the weights once and serves within the JAX
    package's own limit of the float engine (rel < 0.2,
    ``tests/test_serving.py``), and differs from it."""
    outs = {}
    for flag in ((), ("--int8",)):
        engine, batcher, _ = _build("--preset", "tiny-cr", "--sampler_steps", "3", *flag)
        batcher.shutdown()
        randomize_parameters(engine.model, 2)
        engine.swap_params(dict(engine.model.named_parameters()))
        outs[bool(flag)] = engine.generate(4, None, np.ones((2, 8, 8, 3), np.float32))
        if flag:
            qt, st = engine.params
            assert {t.dtype for t in qt.values()} == {torch.int8, torch.float32}
            assert len(engine.leaves()) == 2 * len(engine.names)
            # a hot swap packs the new weights
            engine.swap_params({k: v * 1.5 for k, v in engine.model.named_parameters()})
            assert any(not torch.equal(engine.params[1][k], st[k]) for k in st)
    a, b = outs[False], outs[True]
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert np.isfinite(b).all() and 0 < rel < 0.2


def _wide_dit(**fields):
    """``tiny-dit`` at hidden 256 (wide enough for the W8A8 route: 64 x 16
    tokens) with seeded weights, and ``SamplerEngine`` s of it, batch 64,
    DDIM-2, float32, one for each ``int8_compute`` given."""
    import dataclasses

    from eo_diffusion_torch.cli import presets as TP

    p = TP.get_preset("tiny-dit")
    cfg = dataclasses.replace(p.model_config(bf16=False), hidden_size=256, num_heads=4)
    model = randomize_parameters(TP.build_denoiser(cfg), 3)
    return [SamplerEngine(model, None, TP.build_process(p, 50, 16), 16, 3,
                          ServingConfig(batch_size=64, steps=2, bf16=False, int8_compute=w))
            for w in (False, True)]


def test_w8a8_engine_serves_close_to_float():
    """``int8_compute`` (W8A8) on a DiT wide enough for the route (hidden 256,
    64 x 16 tokens): within the JAX package's own limit of the float engine
    (rel < 0.2), and not equal to it."""
    from eo_diffusion_torch.nn import primitives as NP

    outs, calls, real = {}, [], NP.int8_linear
    for eng in _wide_dit():
        w8a8 = eng.cfg.int8_compute
        NP.int8_linear = lambda *a: calls.append(w8a8) or real(*a)
        try:
            outs[w8a8] = eng.generate(3)
        finally:
            NP.int8_linear = real
    assert calls.count(False) == 0 and calls.count(True) > 0
    a, b = outs[False], outs[True]
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert np.isfinite(b).all() and 0 < rel < 0.2


def test_w8a8_route_belongs_to_the_engines_thread():
    """A float engine's batch runs while another thread's ``int8_compute``
    engine holds the W8A8 context (paused at its first model call): each
    gives the bytes it gives alone. The route is the calling thread's, as
    in JAX, where it is fixed when a program is traced."""
    from eo_diffusion_torch.nn import primitives as NP

    flt, w8 = _wide_dit()
    alone = {eng.cfg.int8_compute: eng.generate(3) for eng in (flt, w8)}
    assert not np.array_equal(alone[False], alone[True])
    inside, release, got = threading.Event(), threading.Event(), {}

    def pause(module, args):
        if NP._INT8_DENSE.get() and not inside.is_set():
            inside.set()
            release.wait(60)

    hook = flt.model.register_forward_pre_hook(pause)  # the engines share the model
    worker = threading.Thread(target=lambda: got.update({True: w8.generate(3)}))
    try:
        worker.start()
        assert inside.wait(60)
        got[False] = flt.generate(3)
    finally:
        release.set()
        worker.join(120)
        hook.remove()
    for w8a8 in (False, True):
        np.testing.assert_array_equal(got[w8a8], alone[w8a8])


def test_profile_serve_times_the_engine_beside_a_direct_call(tmp_path):
    """``tools/profile_serve``: the engine's batch (``functional_call``) and
    the direct call's are the same bits, and both are timed."""
    from eo_diffusion_torch.tools import profile_serve

    out = tmp_path / "p.json"
    res = profile_serve.main(["--preset", "tiny-cr", "--device", "cpu", "--batch_size", "2",
                              "--sampler_steps", "2", "--no_bf16", "--rounds", "1",
                              "--out", str(out)])
    assert json.loads(out.read_text()) == res
    assert [len(v) for v in res["seconds"].values()] == [1, 1] and res["engine_over_direct"] > 0
    assert (res["preset"], res["steps"], res["device"]) == ("tiny-cr", 2, "cpu")
