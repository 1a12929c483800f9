"""Fixed-shape sampling engine and request-coalescing batcher (counterpart
of ``eo_diffusion_tpu/serving/engine.py``).

* **One sampler, one batch size.** The sampler configuration (kind, steps,
  eta, spacing, guidance) and the device batch ``B`` are fixed when the
  engine is built; every request is served by the same full-``B`` program.
  Requests of other sizes are packed into ``B`` rows and short batches are
  padded (pad rows are computed and discarded), so every batch launches the
  same kernels at the same shapes.
* **Parameters are inputs of the program.** :meth:`SamplerEngine.program`
  takes the parameters as a flat tuple of tensors and calls the model
  through ``torch.func.functional_call``, so ``serving/export.py`` exports
  it with the parameters as inputs (``int8`` keeps them packed: int8 values
  and scales, dequantized inside). The live engine runs the same function
  on its stored leaves, so a hot swap replaces the leaves and leaves the
  model's own parameters as they are.
* **Draws are inputs too.** The start noise and every noise the sampler
  asks for come from the batch's seed (``serving/seeding.py``); the program
  receives them, so an exported artifact reproduces the live engine's bytes
  for a seed.
* **Coalescing window.** The batcher waits up to ``batch_window_ms`` after
  the first request to fill a batch. Seeded requests run as their own batch,
  so a seed means reproducible bytes.

The engine samples under ``torch.no_grad()`` on the model's device: the
attention and GroupNorm kernels run as the ``eo::`` custom ops
(``ops/library.py``) there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from eo_diffusion_torch.serving import seeding

__all__ = ["ServingConfig", "SamplerEngine", "BatchingEngine"]


@dataclasses.dataclass
class ServingConfig:
    batch_size: int = 8
    sampler: str = "ddim"  # "ddpm" | "ddim" | "dpm" | "unipc" | "flow" | "bridge"
    steps: int = 50
    eta: float = 0.0
    ddim_spacing: str = "uniform"
    flow_method: str = "euler"
    guidance_scale: float = 1.0
    # CFG-rescale phi (arXiv:2305.08891 §3.4) and limited guidance interval
    # (arXiv:2404.07724, normalized noise level), fixed like guidance_scale
    guidance_rescale: float = 0.0
    guidance_interval: Optional[tuple] = None
    # Imagen dynamic thresholding percentile (arXiv:2205.11487); DDPM-family
    # samplers (ddpm/ddim/dpm/unipc) only
    dynamic_threshold: Optional[float] = None
    # perturbed-attention guidance (arXiv:2403.17377, diffusion/pag.py)
    pag_scale: float = 0.0
    num_classes: int = 0  # label vocabulary (0 = unconditional)
    has_null_class: bool = False  # label-CFG against the learned null row
    cond_channels: int = 0  # concat-conditioning width (0 = none)
    bf16: bool = True
    batch_window_ms: float = 20.0
    request_timeout_s: float = 300.0
    max_queue: int = 256
    # per-request image cap: n > batch_size streams through ceil(n/B) device
    # batches
    max_request: int = 1024
    # weight-only int8 (utils/quantize.py): weights stored int8 with
    # per-channel scales, dequantized on every generate (W8A16)
    int8: bool = False
    # W8A8 (nn/primitives.int8_dense_compute): large Dense products as int8
    # x int8 -> int32 with in-call weight and activation scales
    int8_compute: bool = False
    # shard each device batch over the visible cards: ROADMAP queue 1, item 16
    dp: bool = False


class SamplerEngine:
    """Owns the model, its parameters, the process and the one sampler.

    ``generate(seed, y, cond)`` always computes a full ``B``-row batch;
    callers slice out their rows. ``params`` is a state dict of the model's
    parameters (None: the model's own). Thread-safe: calls hold a lock, and
    the batcher serializes through one worker anyway.
    """

    def __init__(self, model: torch.nn.Module, params: Optional[Dict[str, torch.Tensor]],
                 diffusion, image_size: int, channels: int, cfg: ServingConfig):
        if cfg.dp:
            raise NotImplementedError(
                "data-parallel serving (ServingConfig.dp, cli.serve --dp) is not ported yet "
                "(ROADMAP queue 1, item 16)")
        self.model, self.diffusion = model.eval(), diffusion
        self.image_size, self.channels, self.cfg = image_size, channels, cfg
        self.device = next(model.parameters()).device
        self.dtype = torch.bfloat16 if cfg.bf16 else torch.float32
        self.names = [n for n, _ in model.named_parameters()]
        inner = getattr(diffusion, "diffusion", diffusion)  # a latent process's grid
        self.grid = (cfg.batch_size, inner.image_size, inner.image_size, inner.in_channels)
        self._lock = threading.Lock()

        gkw = {}
        if cfg.dynamic_threshold is not None:
            assert cfg.sampler in ("ddpm", "ddim", "dpm", "unipc"), (
                "dynamic_threshold rescales the DDPM-family pred-x0 clamp "
                f"(ddpm/ddim/dpm/unipc); sampler={cfg.sampler} has no such site")
            gkw["dynamic_threshold"] = cfg.dynamic_threshold
        if cfg.pag_scale > 0.0:
            assert cfg.sampler in ("ddpm", "ddim", "dpm", "unipc", "flow"), (
                "pag_scale wraps the denoiser under the generative chain "
                f"(ddpm/ddim/dpm/unipc/flow); sampler={cfg.sampler} is a "
                "translation/distilled map PAG does not apply to")
        if cfg.guidance_scale != 1.0:
            # a CFG branch must exist: without one the samplers would take the
            # scale and never double the batch, serving unguided samples
            assert cfg.sampler != "bridge", (
                "guidance_scale has no CFG branch on the bridge sampler: the translation "
                "chain starts AT the source image and bridge.sample takes no uncond/y_uncond")
            can_label_cfg = bool(cfg.num_classes) and cfg.has_null_class
            can_image_cfg = cfg.cond_channels > 0 and cfg.sampler != "ddpm"
            assert can_label_cfg or can_image_cfg, (
                "guidance_scale needs a CFG branch: class conditioning with a learned null "
                "row (has_null_class, cli.train --class_dropout), or concat cond on a "
                "sampler with an image-CFG path (ddim/dpm/unipc/flow; ddpm has none)")
            gkw["guidance_scale"] = cfg.guidance_scale
            if cfg.guidance_rescale:
                gkw["guidance_rescale"] = cfg.guidance_rescale
            if cfg.guidance_interval is not None:
                gkw["guidance_interval"] = tuple(cfg.guidance_interval)
        self._gkw = gkw
        # EDM's sampler starts at sigma_max * N(0, 1): its x_T is scaled
        self._start_scale = None
        if type(inner).__name__ == "EDMProcess" and cfg.sampler == "flow":
            from eo_diffusion_torch.diffusion.edm import karras_sigmas

            self._start_scale = float(karras_sigmas(cfg.steps, inner.sigma_min,
                                                    inner.sigma_max, inner.rho)[0])
        self.swap_params(params if params is not None else dict(model.named_parameters()))

    # -- shapes the batcher needs -----------------------------------------------
    @property
    def batch_size(self) -> int:
        return self.cfg.batch_size

    def _blank_y(self) -> Optional[np.ndarray]:
        return (np.zeros((self.cfg.batch_size,), np.int64)
                if self.cfg.num_classes else None)

    def _blank_cond(self) -> Optional[np.ndarray]:
        if not self.cfg.cond_channels:
            return None
        return np.zeros((self.cfg.batch_size, self.image_size, self.image_size,
                         self.cfg.cond_channels), np.float32)

    # -- parameters ---------------------------------------------------------------
    def leaves(self) -> List[torch.Tensor]:
        """The packed parameters as the program's flat inputs: every tensor in
        ``named_parameters`` order (the model's own, detached), or with
        ``int8`` the int8 values then the scales (the JAX engine's ``(qt,
        st)`` order)."""
        if self.cfg.int8:
            qt, st = self.params
            return list(qt.values()) + list(st.values())
        return list(self.params.values())

    def _unflatten(self, leaves: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        n = len(self.names)
        if self.cfg.int8:
            from eo_diffusion_torch.utils.quantize import dequantize_tree

            return dequantize_tree(dict(zip(self.names, leaves[:n])),
                                   dict(zip(self.names, leaves[n:])))
        return dict(zip(self.names, leaves))

    def swap_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Hot-swap the weights (a state dict of the model's parameters): kept
        as float32 on the engine's device, or with ``int8`` packed once as
        ``(int8 dict, scale dict)``."""
        params = {n: params[n].detach().to(self.device, torch.float32) for n in self.names}
        if self.cfg.int8:
            from eo_diffusion_torch.utils.quantize import (flax_views, quantize_tree,
                                                           quantized_bytes)

            packed = quantize_tree(params, flax_views(self.model))
            print(f"serving int8: params packed to {quantized_bytes(packed[0]) / 1e6:.1f} MB "
                  "(weight-only W8A16)")
        with self._lock:
            self.params = packed if self.cfg.int8 else params

    # -- the program -------------------------------------------------------------
    def program(self, leaves: Sequence[torch.Tensor], x_T: torch.Tensor, noise,
                y: Optional[torch.Tensor], cond: Optional[torch.Tensor]) -> torch.Tensor:
        """One full batch from the parameters ``leaves`` (:meth:`leaves`), the
        start noise ``x_T`` (the grid's shape), the sampler's noises
        (``noise``: a ``[k, *grid]`` tensor, or a function of the draw's
        index that draws it), labels ``y`` ``[B]`` and cond ``[B, H, W, Cc]``
        (None where the engine has none). Returns ``[B, H, W, C]`` float32.
        The live engine and the exported artifact both run this function."""
        model, params = self.model, self._unflatten(leaves)

        def fn(x, t, c, yy):
            return torch.func.functional_call(model, params, (x, t), {"cond": c, "y": yy})

        if self.cfg.pag_scale > 0.0:
            from eo_diffusion_torch.diffusion.pag import pag_model_fn

            fn = pag_model_fn(fn, self.cfg.pag_scale)
        return self._sample(fn, x_T, noise, y, cond)

    def _sample(self, fn, x_T, noise, y, cond) -> torch.Tensor:
        """The configured sampler over the model function ``fn(x, t, cond,
        y)``, the rest as :meth:`program` takes them."""
        cfg, d, B = self.cfg, self.diffusion, self.cfg.batch_size
        count = [0]

        def noise_fn(i, role):
            j, count[0] = count[0], count[0] + 1
            return noise[j] if torch.is_tensor(noise) else noise(j)

        kw = dict(self._gkw)
        if cfg.guidance_scale != 1.0:
            if cfg.num_classes and cfg.has_null_class:
                kw["y_uncond"] = torch.full((B,), cfg.num_classes, dtype=torch.long,
                                            device=x_T.device)
            elif cond is not None and cfg.sampler != "ddpm":
                kw["uncond"] = torch.zeros_like(cond)
        common = dict(device=x_T.device, cond=cond, y=y, dtype=self.dtype, noise_fn=noise_fn)
        if self._start_scale is not None:
            x_T = self._start_scale * x_T
        if cfg.sampler == "flow":
            out = d.sample(fn, B, num_steps=cfg.steps, method=cfg.flow_method, x_T=x_T,
                           **common, **kw)
        elif cfg.sampler == "bridge":
            # the chain starts AT the source image (cond); eta reuses the DDIM knob
            out = d.sample(fn, B, num_steps=cfg.steps, eta=cfg.eta, **common)
        elif cfg.sampler == "dpm":
            out = d.dpm_sample(fn, B, num_steps=cfg.steps, x_T=x_T, **common, **kw)
        elif cfg.sampler == "unipc":
            out = d.unipc_sample(fn, B, num_steps=cfg.steps, x_T=x_T, **common, **kw)
        elif cfg.sampler == "ddpm":
            out = d.ddpm_sample(fn, B, x_T=x_T, **common, **kw)
        else:
            out = d.ddim_sample(fn, B, num_steps=cfg.steps, eta=cfg.eta,
                                method=cfg.ddim_spacing, x_T=x_T, **common, **kw)
        return out.x.float()

    def _run(self, leaves, x_T, noise, y, cond) -> torch.Tensor:
        """:meth:`program` under ``no_grad`` on the engine's device, with
        ``int8_compute``'s context around it."""
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        w8a8 = contextlib.nullcontext()
        if self.cfg.int8_compute:
            from eo_diffusion_torch.nn.primitives import int8_dense_compute

            w8a8 = int8_dense_compute()
        with ctx, torch.no_grad(), w8a8:
            return self.program(leaves, x_T, noise, y, cond)

    def _inputs(self, y, cond):
        dev = self.device
        y_t = None if y is None else torch.as_tensor(np.asarray(y), dtype=torch.long,
                                                     device=dev)
        c_t = None if cond is None else torch.as_tensor(np.asarray(cond, np.float32),
                                                        device=dev)
        return y_t, c_t

    def generate(self, seed: int, y: Optional[np.ndarray] = None,
                 cond: Optional[np.ndarray] = None) -> np.ndarray:
        """One full device batch from ``seed`` -> ``[B, H, W, C]`` float32 numpy
        (the model's data range)."""
        with self._lock:
            gen = seeding.generator(seed, self.device)
            x_T = seeding.normal(gen, self.grid)
            y_t, c_t = self._inputs(y, cond)
            # int8 leaves are dequantized inside, on every batch, as the JAX
            # program does
            out = self._run(self.leaves(), x_T, lambda j: seeding.normal(gen, self.grid),
                            y_t, c_t)
            return out.cpu().numpy()

    def count_draws(self):
        """``(draws, calls)``: the noises the sampler draws a batch after the
        start noise, and its model calls; the sampler run once with a
        stand-in model that returns zeros."""
        counts = [0, 0]

        def counting(j):
            counts[0] += 1
            return torch.zeros(self.grid, device=self.device)

        def zero(x, t, c, yy):
            counts[1] += 1
            return torch.zeros_like(x)

        y_t, c_t = self._inputs(self._blank_y(), self._blank_cond())
        with torch.no_grad():
            self._sample(zero, torch.zeros(self.grid, device=self.device), counting, y_t, c_t)
        # the zero model has no attention for PAG to perturb: PAG's second
        # call a model call is counted instead
        return counts[0], counts[1] * (2 if self.cfg.pag_scale > 0.0 else 1)

    def warmup(self) -> float:
        """One batch end to end (kernel builds and first calls included);
        returns the wall seconds it took."""
        t0 = time.time()
        self.generate(0, self._blank_y(), self._blank_cond())
        return time.time() - t0


@dataclasses.dataclass
class _Request:
    n: int
    y: Optional[np.ndarray]  # [n] int or None
    cond: Optional[np.ndarray]  # [n, H, W, Cc] or None
    seed: Optional[int]
    # chunk index of a streamed (n > B) seeded request: it draws from
    # seeding.chunk_seed(seed, fold). None = the plain seed, so chunk 0 of a
    # streamed request is byte-identical to a solo n <= B request
    fold: Optional[int] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None


class BatchingEngine:
    """Request coalescing in front of a :class:`SamplerEngine` (JAX
    ``BatchingEngine``, line for line).

    ``submit(n, ...)`` blocks until the request's rows come back. One worker
    thread packs queued requests into ``B``-row device batches: the first
    request opens a ``batch_window_ms`` window; requests arriving inside it
    join until the rows are full. Seeded requests are never packed with
    others; they run as their own batch from their seed. Requests larger
    than ``B`` stream through several device batches (:meth:`submit`);
    ``stats()`` counts each streamed chunk as one request.
    """

    _STOP = object()

    def __init__(self, engine: SamplerEngine, base_seed: int = 0):
        self.engine = engine
        self.cfg = engine.cfg
        self._q: queue.Queue = queue.Queue(maxsize=self.cfg.max_queue)
        self._base_seed = int(base_seed)
        self._batches = 0
        self._images = 0
        self._requests = 0
        self._batch_ms_sum = 0.0
        self._carry = None  # request popped but not fitting the open batch
        self._lat_ms: list = []  # request submit -> done latencies (window)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- public -----------------------------------------------------------------
    def _split_and_enqueue(self, n: int, y, cond, seed):
        """Validate and split a request into <= B-row chunks and enqueue them.

        ``n > batch_size`` streams: ceil(n/B) chunk requests enqueued
        together, so the worker runs them back to back (full-B chunks fill a
        device batch outright; an unseeded remainder coalesces with other
        callers as usual). Seeded streams stay reproducible: chunk i runs solo
        from ``chunk_seed(seed, i)`` (chunk 0 from the plain seed, so its
        bytes match an n <= B request with the same seed)."""
        B = self.engine.batch_size
        assert 1 <= n <= self.cfg.max_request, (
            f"n must be in [1, max_request={self.cfg.max_request}], got {n}")
        if y is not None:
            y = np.asarray(y, np.int64).reshape(n)
            assert self.cfg.num_classes, "engine is not class-conditional"
            # both bounds: a negative label would index the embedding from the end
            assert 0 <= int(y.min()) and int(y.max()) < self.cfg.num_classes, (
                f"label out of vocabulary [0, {self.cfg.num_classes}): {y.tolist()}")
        if cond is not None:
            cond = np.asarray(cond, np.float32)
            assert self.cfg.cond_channels, "engine is not concat-conditioned"
            want = (n, self.engine.image_size, self.engine.image_size,
                    self.cfg.cond_channels)
            assert cond.shape == want, (cond.shape, want)
        reqs = []
        off = 0
        while off < n:
            k = min(B, n - off)
            reqs.append(_Request(
                n=k,
                y=None if y is None else y[off:off + k],
                cond=None if cond is None else cond[off:off + k],
                seed=seed,
                fold=(off // B if seed is not None and off else None)))
            off += k
        for req in reqs:
            self._q.put(req, timeout=self.cfg.request_timeout_s)
        return reqs

    def _record_latency(self, t0: float) -> None:
        self._lat_ms.append((time.time() - t0) * 1e3)
        if len(self._lat_ms) > 1024:  # bounded window for the percentiles
            del self._lat_ms[:512]

    def submit(self, n: int, y=None, cond=None, seed: Optional[int] = None) -> np.ndarray:
        """Sample ``n`` images; blocks until ALL rows come back (the n >
        batch_size split: :meth:`_split_and_enqueue`; :meth:`submit_iter`
        yields the chunks as they finish instead)."""
        t0 = time.time()
        reqs = self._split_and_enqueue(n, y, cond, seed)
        # one shared deadline for the whole request, not per chunk
        deadline = t0 + self.cfg.request_timeout_s
        error = timed_out = None
        for req in reqs:
            if not req.done.wait(max(deadline - time.time(), 0.0)):
                timed_out = True
                break  # later chunks can't have finished in order anyway
            if req.error is not None and error is None:
                error = req.error
        if timed_out:
            raise TimeoutError(f"sampling did not finish within "
                               f"{self.cfg.request_timeout_s}s")
        if error is not None:
            raise error
        self._record_latency(t0)
        if len(reqs) == 1:
            return reqs[0].result
        return np.concatenate([r.result for r in reqs], axis=0)

    def submit_iter(self, n: int, y=None, cond=None, seed: Optional[int] = None):
        """Streaming :meth:`submit`: an iterator that yields each chunk's rows
        (``[<=B, H, W, C]`` float32, in request order) as soon as its device
        batch completes. The chunks are enqueued before the first ``next()``;
        concatenating every yielded array gives ``submit``'s bytes. Raises
        TimeoutError or the engine's error from the failing chunk on."""
        t0 = time.time()
        reqs = self._split_and_enqueue(n, y, cond, seed)
        deadline = t0 + self.cfg.request_timeout_s

        def _gen():
            for req in reqs:
                if not req.done.wait(max(deadline - time.time(), 0.0)):
                    raise TimeoutError(
                        f"sampling did not finish within {self.cfg.request_timeout_s}s")
                if req.error is not None:
                    raise req.error
                yield req.result
            self._record_latency(t0)

        return _gen()

    def stats(self) -> dict:
        lat = sorted(self._lat_ms)
        pct = (lambda q: lat[min(int(q * len(lat)), len(lat) - 1)] if lat else 0.0)
        return {
            "requests": self._requests,
            "images": self._images,
            "batches": self._batches,
            "avg_batch_ms": (self._batch_ms_sum / self._batches if self._batches else 0.0),
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "queue_depth": self._q.qsize(),
            "batch_size": self.engine.batch_size,
            "sampler": self.cfg.sampler,
            "steps": self.cfg.steps,
        }

    def shutdown(self) -> None:
        self._q.put(self._STOP)
        self._worker.join(timeout=10)

    # -- worker -------------------------------------------------------------------
    def _gather(self, first: _Request):
        """Coalesce: [first] + whatever arrives inside the window and fits."""
        B = self.engine.batch_size
        group, rows = [first], first.n
        if first.seed is not None:
            return group  # seeded: solo batch
        deadline = time.time() + self.cfg.batch_window_ms / 1e3
        while rows < B:
            left = deadline - time.time()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is self._STOP:
                self._q.put(self._STOP)  # re-post for the outer loop
                break
            if nxt.seed is not None or rows + nxt.n > B:
                # can't join this batch: carry it to the FRONT of the next
                # group (a queue re-post would put it behind later arrivals)
                self._carry = nxt
                break
            group.append(nxt)
            rows += nxt.n
        return group

    def _run_group(self, group):
        B = self.engine.batch_size
        rows = sum(r.n for r in group)
        y = cond = None
        if self.cfg.num_classes:
            y = np.zeros((B,), np.int64)
        if self.cfg.cond_channels:
            cond = self.engine._blank_cond()
        off = 0
        for r in group:
            if r.y is not None:
                y[off:off + r.n] = r.y
            if r.cond is not None:
                cond[off:off + r.n] = r.cond
            off += r.n
        if group[0].seed is not None:
            seed = group[0].seed
            if group[0].fold is not None:  # streamed chunk i > 0 of a seeded request
                seed = seeding.chunk_seed(seed, group[0].fold)
        else:
            seed = seeding.chunk_seed(self._base_seed, self._batches)
        t0 = time.time()
        out = self.engine.generate(seed, y, cond)
        ms = (time.time() - t0) * 1e3
        self._batches += 1
        self._images += rows
        self._requests += len(group)
        self._batch_ms_sum += ms
        off = 0
        for r in group:
            r.result = out[off:off + r.n]
            off += r.n
            r.done.set()

    def _loop(self):
        while True:
            if self._carry is not None:
                first, self._carry = self._carry, None
            else:
                first = self._q.get()
            if first is self._STOP:
                # fail anything still waiting instead of hanging its caller
                leftovers = [self._carry] if self._carry is not None else []
                while True:
                    try:
                        r = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if r is not self._STOP:
                        leftovers.append(r)
                for r in leftovers:
                    r.error = RuntimeError("serving engine shut down")
                    r.done.set()
                return
            group = self._gather(first)
            try:
                self._run_group(group)
            except BaseException as e:  # propagate to every waiting caller
                for r in group:
                    r.error = e
                    r.done.set()
