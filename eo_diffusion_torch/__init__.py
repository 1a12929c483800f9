"""eo_diffusion_torch: the PyTorch/CUDA port of eo_diffusion_tpu for one NVIDIA H100.

The sampling path so far: the clouds UNet with DDPM (RePaint) and DDIM
samplers, driven by ``python -m eo_diffusion_torch.cli.inference``. Its
UNet self-attention runs through a hand-written CUDA kernel
(``ops/csrc/attention_fwd.cu``), built with ``nvcc`` on first use.

Entry points run on the GPU unless the caller asks for the CPU
(``--device cpu``, ``device="cpu"``). The package imports torch and numpy,
never JAX or eo_diffusion_tpu; the JAX package stays the reference that the
tests hold it against.
"""

__version__ = "0.1.0"
