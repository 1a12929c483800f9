"""Dependency-free JSON-over-HTTP front end for the batching engine
(counterpart of ``eo_diffusion_tpu/serving/http.py``).

Endpoints (all JSON):

* ``POST /v1/generate`` — body ``{"n": 1, "seed": 123, "y": [0],
  "cond_b64": "<base64 .npy>", "format": "png"|"npy"}``; every field but
  ``n`` optional. Returns ``{"images": [<base64 png>, ...]}`` (one entry
  per sample, values rescaled to the dataset range) or
  ``{"npy_b64": <base64 .npy>}`` with the raw float32 ``[n, H, W, C]``
  model-range array. ``n`` may exceed the engine batch size (up to
  ``ServingConfig.max_request``): the batcher streams the request through
  multiple device batches and returns the concatenated rows.
* ``POST /v1/generate_stream`` — same body as ``/v1/generate``; responds
  with chunked ``application/x-ndjson``: one line per completed device
  batch (``{"chunk": i, "images": [...]}`` or ``{"chunk": i, "npy_b64":
  ...}``) streamed AS the sampler finishes it, then a terminal
  ``{"done": true, "images_total": N}`` line. A mid-stream engine failure
  arrives as an ``{"error": ...}`` line (the HTTP status is already sent).
  Concatenating the chunk rows reproduces ``/v1/generate``'s bytes for the
  same seed.
* ``GET /healthz`` — liveness + the engine's fixed sampler configuration.
* ``GET /stats`` — request/image/batch counters, request latency
  percentiles, and the mean device-batch latency.
* ``POST /v1/reload`` — ``{"ckpt": "<path>"}`` hot-swaps the served
  weights (they are inputs of the engine's program). Admin-only surface:
  bind the server to localhost (the default) — the path is read from the
  request.

Uses only the standard library (``http.server`` + threads) and numpy; PNG
encoding imports PIL at the call. Concurrency note:
``ThreadingHTTPServer`` gives one thread per connection; the handlers only
block on :meth:`BatchingEngine.submit`, so concurrent requests coalesce
into shared device batches — that is the whole point.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

__all__ = ["make_server", "serve_forever"]


def _png_b64(img01: np.ndarray) -> str:
    import PIL.Image

    arr = (np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _npy_b64(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _b64_npy(s: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(s)), allow_pickle=False)


class _Handler(BaseHTTPRequestHandler):
    # the server object carries .batcher / .meta (see make_server)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default; --verbose flips
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            self._reply(200, {"ok": True, **self.server.meta})
        elif self.path == "/stats":
            self._reply(200, self.server.batcher.stats())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path == "/v1/reload":
            reload_fn = getattr(self.server, "reload_fn", None)
            if reload_fn is None:
                self._reply(404, {"error": "no reload_fn configured"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                info = reload_fn(str(req["ckpt"]))
            except (KeyError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"need a 'ckpt' field: {e}"})
                return
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {"ok": True, **(info or {})})
            return
        if self.path not in ("/v1/generate", "/v1/generate_stream"):
            self._reply(404, {"error": f"no route {self.path}"})
            return
        streaming = self.path.endswith("_stream")
        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            n = int(req.get("n", 1))
            y = req.get("y")
            if y is not None:
                y = [y] * n if isinstance(y, int) else list(y)
                assert len(y) == n, f"y must have n={n} entries"
            cond = (_b64_npy(req["cond_b64"])
                    if req.get("cond_b64") is not None else None)
            seed = req.get("seed")
            seed = None if seed is None else int(seed)
            if streaming:
                # validation + enqueue happen here (eagerly), so bad
                # requests still get a clean 400 before headers go out
                chunks = self.server.batcher.submit_iter(
                    n, y=y, cond=cond, seed=seed)
            else:
                out = self.server.batcher.submit(n, y=y, cond=cond, seed=seed)
        except (AssertionError, ValueError, KeyError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        except TimeoutError as e:
            self._reply(503, {"error": str(e)})
            return
        except Exception as e:  # engine-side failure
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        fmt = req.get("format", "png")
        if streaming:
            self._stream_chunks(chunks, fmt)
            return
        if fmt == "npy":
            self._reply(200, {"npy_b64": _npy_b64(out),
                              "shape": list(out.shape)})
        else:
            lo, hi = self.server.meta["data_range"]
            img01 = (out - lo) / (hi - lo)
            self._reply(200, {"images": [_png_b64(img01[i])
                                         for i in range(out.shape[0])],
                              "shape": list(out.shape)})

    def _stream_chunks(self, chunks, fmt: str) -> None:
        """Chunked-transfer NDJSON: one line per finished device batch."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def wline(obj: dict) -> None:
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data + b"\r\n")
            self.wfile.flush()  # the whole point: bytes leave per chunk

        total = 0
        try:
            for i, arr in enumerate(chunks):
                if fmt == "npy":
                    line = {"chunk": i, "npy_b64": _npy_b64(arr),
                            "shape": list(arr.shape)}
                else:
                    lo, hi = self.server.meta["data_range"]
                    img01 = (arr - lo) / (hi - lo)
                    line = {"chunk": i,
                            "images": [_png_b64(img01[j])
                                       for j in range(arr.shape[0])]}
                total += arr.shape[0]
                wline(line)
            wline({"done": True, "images_total": total})
        except Exception as e:
            # status line already went out; signal failure in-band
            wline({"error": f"{type(e).__name__}: {e}"})
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()


def make_server(batcher, meta: dict, host: str = "127.0.0.1",
                port: int = 0, verbose: bool = False, reload_fn=None
                ) -> Tuple[ThreadingHTTPServer, int]:
    """Build the HTTP server (port 0 = ephemeral); returns (server, port).

    ``reload_fn(ckpt_path) -> dict|None`` enables POST /v1/reload."""
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.batcher = batcher
    srv.meta = dict(meta)
    srv.verbose = verbose
    srv.reload_fn = reload_fn
    return srv, srv.server_address[1]


def serve_forever(srv: ThreadingHTTPServer,
                  background: bool = False) -> Optional[threading.Thread]:
    if background:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return t
    srv.serve_forever()
    return None
