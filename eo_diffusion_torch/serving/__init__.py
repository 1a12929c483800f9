"""Serving: batched, always-warm sampling behind an HTTP API, and the
exported artifact (counterpart of ``eo_diffusion_tpu/serving``).

* :mod:`~eo_diffusion_torch.serving.engine`: the fixed-shape sampler
  (``SamplerEngine``) and the request-coalescing batcher
  (``BatchingEngine``): concurrent requests are packed into one device batch
  within a latency window.
* :mod:`~eo_diffusion_torch.serving.http`: a dependency-free
  ``ThreadingHTTPServer`` JSON API (/v1/generate, /v1/generate_stream,
  /healthz, /stats, /v1/reload).
* :mod:`~eo_diffusion_torch.serving.export`: the engine's program as a
  ``torch.export`` artifact, and its loader;
  :mod:`~eo_diffusion_torch.serving.artifact_server` serves one.
* :mod:`~eo_diffusion_torch.serving.seeding`: the seeded draws both share.
* ``cli/serve.py`` and ``cli/export_model.py``: the entry points.
"""

from eo_diffusion_torch.serving.engine import (  # noqa: F401
    BatchingEngine,
    SamplerEngine,
    ServingConfig,
)
