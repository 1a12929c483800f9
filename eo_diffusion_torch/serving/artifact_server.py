"""Deployment-host HTTP server for an exported artifact (counterpart of
``eo_diffusion_tpu/serving/artifact_server.py``).

The other half of ``serving/export.py``: serve a ``cli.export_model``
artifact on a host that has no model code. This module imports only the
standard library, numpy, torch and the artifact loader (itself torch, numpy,
the op library and the seeding module; ``tests/test_torch_export.py``
checks the imports in a fresh process). No model, no sampler, no preset, no
batcher: the artifact's one program is the server.

``python -m eo_diffusion_torch.serving.artifact_server --artifact DIR
--port 8000`` then::

    POST /v1/generate {"n": 4, "seed": 7, "y": [0,1,2,0], "cond_b64": ...}
    ->   {"shape": [4,H,W,C], "dtype": "float32", "npy_b64": ...}

Responses are base64 ``.npy`` bytes. ``n`` must be at most the artifact's
batch size: the program always computes a full batch and the server slices;
a seeded request is reproducible byte for byte (within the port, on the
artifact's device). GET /healthz returns the manifest.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np


class ArtifactEngine:
    """The deserialized program + a dispatch lock (one program, fixed B)."""

    def __init__(self, artifact_dir: str, device: Optional[str] = None):
        from eo_diffusion_torch.serving.export import load_model

        self.generate, self.manifest = load_model(artifact_dir, device)
        self.batch_size = int(self.manifest["batch_size"])
        self._lock = threading.Lock()

    def run(self, n: int, seed: int, y=None, cond=None) -> np.ndarray:
        # explicit raises, not asserts: these carry the documented
        # 400-on-bad-input contract and must survive ``python -O``
        B = self.batch_size
        if not 1 <= n <= B:
            raise ValueError(f"n must be in [1, {B}] (fixed-shape artifact), "
                             f"got {n}")
        if y is not None:
            y = np.asarray(y, np.int64).reshape(-1)
            if len(y) != n:
                raise ValueError(f"y has {len(y)} entries for n={n}")
            y = np.concatenate([y, np.zeros((B - n,), np.int64)])
        if cond is not None:
            cond = np.asarray(cond, np.float32)
            if cond.shape[0] != n:
                raise ValueError(
                    f"cond batch dim {cond.shape[0]} != n={n} ({cond.shape})")
            pad = np.zeros((B - n,) + cond.shape[1:], np.float32)
            cond = np.concatenate([cond, pad])
        with self._lock:
            out = self.generate(int(seed), y=y, cond=cond)
        return out[:n]


def _json_response(handler, code: int, payload: dict) -> None:
    body = json.dumps(payload).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class _Handler(BaseHTTPRequestHandler):
    engine: ArtifactEngine  # set by make_server
    quiet = True

    def log_message(self, fmt, *args):  # noqa: N802
        if not self.quiet:
            super().log_message(fmt, *args)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            _json_response(self, 200, {"ok": True,
                                       "manifest": self.engine.manifest})
        else:
            _json_response(self, 404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/v1/generate":
            _json_response(self, 404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            n = int(req.get("n", 1))
            seed = int(req.get("seed", 0))
            y = req.get("y")
            cond = None
            if req.get("cond_b64"):
                cond = np.load(io.BytesIO(
                    base64.b64decode(req["cond_b64"])), allow_pickle=False)
            out = self.engine.run(n, seed, y=y, cond=cond)
            buf = io.BytesIO()
            np.save(buf, out, allow_pickle=False)
            _json_response(self, 200, {
                "shape": list(out.shape), "dtype": str(out.dtype),
                "npy_b64": base64.b64encode(buf.getvalue()).decode()})
        except (ValueError, AssertionError) as e:
            _json_response(self, 400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — surface, don't kill the thread
            _json_response(self, 500, {"error": f"{type(e).__name__}: {e}"})


def make_server(artifact_dir: str, host: str = "127.0.0.1", port: int = 0,
                quiet: bool = True,
                engine: Optional[ArtifactEngine] = None,
                ) -> Tuple[ThreadingHTTPServer, int]:
    """Build the server (port 0 = ephemeral); returns (server, bound port)."""
    eng = engine or ArtifactEngine(artifact_dir)

    class Handler(_Handler):
        pass

    Handler.engine = eng
    Handler.quiet = quiet
    srv = ThreadingHTTPServer((host, port), Handler)
    return srv, srv.server_address[1]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Serve an exported artifact (torch + numpy host, no model code)")
    p.add_argument("--artifact", required=True,
                   help="directory written by cli.export_model")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="0 = ephemeral")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="default: the device the artifact was exported on")
    args = p.parse_args(argv)

    engine = ArtifactEngine(args.artifact, args.device)
    # warm the loaded program before accepting traffic
    engine.run(1, 0)
    srv, port = make_server(args.artifact, args.host, args.port,
                            quiet=not args.verbose, engine=engine)
    m = engine.manifest
    print(f"artifact server on {args.host}:{port} — {m['sampler']}-"
          f"{m['steps']} B={m['batch_size']} {m['image_size']}px "
          f"({m['param_bytes'] / 1e6:.1f} MB params)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
