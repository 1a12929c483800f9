"""eo_diffusion_torch: the PyTorch/CUDA port of eo_diffusion_tpu for one NVIDIA H100.

So far: the clouds UNet samples (DDPM with RePaint, DDIM, tiled DDIM) and
trains, the DiT samples and trains with DDPM/DDIM or rectified flow (tiled
too), and the latent presets train a first-stage autoencoder and diffuse
on its latents, driven by ``python -m eo_diffusion_torch.cli.inference``
and ``...cli.train``. Their
attention and GroupNorms, and the W8A8 attention probe, run through
hand-written CUDA kernels (``ops/csrc/*.cu``), built with ``nvcc`` on first
use.

Entry points run on the GPU unless the caller asks for the CPU
(``--device cpu``, ``device="cpu"``). The package imports torch and numpy,
never JAX or eo_diffusion_tpu; the JAX package stays the reference that the
tests hold it against.
"""

__version__ = "0.1.0"
