"""The first-stage autoencoder of latent diffusion, in PyTorch.

Counterpart of ``eo_diffusion_tpu/models/autoencoder.py``: a small
convolutional AE (stride-2 conv encoder, nearest-upsample decoder) whose
``encode(x) -> z`` / ``decode(z) -> x`` halves are the first stage of
:class:`~eo_diffusion_torch.diffusion.latent.LatentDiffusion` (the CompVis
``encode_first_stage`` / ``decode_first_stage`` split, reference
``diffusion/ddpm.py:954, 834``). Tensors are NHWC.

* Every ``silu(norm(h))`` is one ``GroupNorm32(h, act="silu")`` call: on the
  card one launch of the GroupNorm + SiLU kernel.
* The stride-2 ``enc_down{i}`` convs pad one pixel on each side, as the JAX
  ``Conv(stride=2)`` does (torch-style explicit padding), so both put the
  window on the same pixels.
* Submodules keep the flax names (``enc_stem``, ``enc_norm{i}``,
  ``enc_down{i}``, ``enc_norm_out``, ``enc_out``, ``dec_stem``,
  ``dec_norm{i}``, ``dec_up{i}``, ``dec_norm_out``, ``dec_out``), so
  :func:`eo_diffusion_torch.weights.ae_state_dict_from_jax_params` maps a
  flax tree by name.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from eo_diffusion_torch.nn.primitives import Conv, GroupNorm32, nearest_upsample_2d

__all__ = ["AutoencoderConfig", "ConvAutoencoder"]


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 64
    num_down: int = 2  # spatial reduction = 2**num_down
    dtype: torch.dtype = torch.float32  # compute dtype (params stay float32)


class ConvAutoencoder(nn.Module):
    """Small convolutional AE: ``forward(x)`` autoencodes, :meth:`encode` and
    :meth:`decode` give the two halves; :meth:`decode` returns float32."""

    def __init__(self, config: AutoencoderConfig):
        super().__init__()
        cfg = self.config = config
        ch, dt = cfg.base_channels, cfg.dtype
        self.enc_stem = Conv(cfg.in_channels, ch, 3, dtype=dt)
        self.enc_norms, self.enc_downs = [], []
        for i in range(cfg.num_down):
            self.enc_norms.append(self._add(f"enc_norm{i}", GroupNorm32(ch)))
            self.enc_downs.append(self._add(f"enc_down{i}", Conv(ch, ch * 2, 3, stride=2,
                                                                  dtype=dt)))
            ch *= 2
        self.enc_norm_out = GroupNorm32(ch)
        self.enc_out = Conv(ch, cfg.latent_channels, 1, dtype=dt)

        self.dec_stem = Conv(cfg.latent_channels, ch, 3, dtype=dt)
        self.dec_norms, self.dec_ups = [], []
        for i in range(cfg.num_down):
            self.dec_norms.append(self._add(f"dec_norm{i}", GroupNorm32(ch)))
            self.dec_ups.append(self._add(f"dec_up{i}", Conv(ch, ch // 2, 3, dtype=dt)))
            ch //= 2
        self.dec_norm_out = GroupNorm32(ch)
        self.dec_out = Conv(ch, cfg.in_channels, 3, dtype=dt)

    def _add(self, name: str, module: nn.Module) -> nn.Module:
        self.add_module(name, module)  # the flax name
        return module

    def set_impl(self, norm: str = "auto", conv: str = "auto") -> "ConvAutoencoder":
        """Put every GroupNorm on its kernel (``"auto"``) or its plain version
        (``"plain"``), and every conv's weight gradient likewise."""
        for name, impl in (("norm", norm), ("conv", conv)):
            if impl not in ("auto", "plain"):
                raise ValueError(f"{name} impl must be 'auto' or 'plain', got {impl!r}")
        for m in self.modules():
            if isinstance(m, GroupNorm32):
                m.impl = norm
            elif isinstance(m, Conv):
                m.impl = conv
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, H, W, in_channels] -> [N, H/2**d, W/2**d, latent_channels]``
        in the compute dtype."""
        h = self.enc_stem(x.to(self.config.dtype))
        for norm, down in zip(self.enc_norms, self.enc_downs):
            h = down(norm(h, act="silu"))
        return self.enc_out(self.enc_norm_out(h, act="silu"))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[N, h, w, latent_channels] -> [N, h*2**d, w*2**d, in_channels]``
        float32."""
        h = self.dec_stem(z.to(self.config.dtype))
        for norm, up in zip(self.dec_norms, self.dec_ups):
            h = up(nearest_upsample_2d(norm(h, act="silu")))
        return self.dec_out(self.dec_norm_out(h, act="silu")).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
