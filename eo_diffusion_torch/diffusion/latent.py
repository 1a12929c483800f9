"""Latent diffusion: the process runs in a first-stage latent space, in PyTorch.

Counterpart of ``eo_diffusion_tpu/diffusion/latent.py`` (the CompVis
``LatentDiffusion`` capability, reference ``diffusion/ddpm.py:628-692, 954,
834``): images are encoded by a frozen first stage, the inner process
(:class:`GaussianDiffusion`, :class:`FlowMatching`, :class:`EDMProcess` or
:class:`BrownianBridge`, sized to the latent grid) trains and samples in
latent space, and samples decode back to pixels. Conditioning images ride
the same encoder; the latent bridge's endpoint is the encoded source.

:class:`LatentDiffusion` offers the surface of the process it wraps that the
:class:`~eo_diffusion_torch.train.trainer.Trainer` and the CLIs touch
(``train_loss`` with its ``noise=`` / ``t=`` hooks, ``ddpm_sample``,
``ddim_sample``, ``dpm_sample``, ``unipc_sample``, ``sample``, ``cond_type``, ``in_channels``,
``image_size``), so a trainer over it trains in latent space and its
previews come out in pixels.

The first stage is frozen: :meth:`LatentDiffusion.encode` and
:meth:`LatentDiffusion.decode` run under ``torch.no_grad()``, so a training
step keeps no graph of the autoencoder and runs only its forward
(:func:`eo_diffusion_torch.train.ae_trainer.make_codec` also turns off its
parameters' gradients). The samplers decode their final ``x`` and any
``log_every`` frames, so a caller gets pixel-space intermediates.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from eo_diffusion_torch.diffusion.bridge import BrownianBridge
from eo_diffusion_torch.diffusion.edm import EDMProcess
from eo_diffusion_torch.diffusion.flow import FlowMatching
from eo_diffusion_torch.diffusion.gaussian import DenoiseFn, DiffusionOutput, GaussianDiffusion

__all__ = ["LatentDiffusion"]


@dataclasses.dataclass(frozen=True)
class LatentDiffusion:
    """Diffusion over ``encode_fn`` latents with pixel-space decode.

    :param diffusion: the inner process sized to the LATENT grid
        (image_size = pixel size / 2**num_down, in_channels = latent_channels).
    :param encode_fn: x ``[N, H, W, C]`` -> z ``[N, h, w, zc]``
    :param decode_fn: z -> x
    :param scale_factor: latent scaling (CompVis scale_factor; 1/std of the
        latents keeps the noise schedule calibrated).
    :param cond_via_encoder: default of the per-call ``encode_cond``: True
        sends concat conditioning images through the first stage (the CompVis
        cond-stage-is-first-stage mode, ddpm.py:954), as the latent CLIs do.
    """

    diffusion: Union[GaussianDiffusion, FlowMatching, EDMProcess, BrownianBridge]
    encode_fn: Callable[[torch.Tensor], torch.Tensor]
    decode_fn: Callable[[torch.Tensor], torch.Tensor]
    scale_factor: float = 1.0
    cond_via_encoder: bool = False

    # -- the inner process's surface (latent-grid sizes) ---------------------

    @property
    def cond_type(self) -> Optional[str]:
        return self.diffusion.cond_type

    @property
    def in_channels(self) -> int:
        return self.diffusion.in_channels

    @property
    def image_size(self) -> int:
        return self.diffusion.image_size

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode_fn(x) * self.scale_factor

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode_fn(z / self.scale_factor)

    def _cond(self, cond, encode_cond: Optional[bool]):
        ec = self.cond_via_encoder if encode_cond is None else encode_cond
        return self.encode(cond) if (cond is not None and ec) else cond

    def train_loss(self, model_fn: DenoiseFn, x0: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   cond: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                   encode_cond: Optional[bool] = None) -> torch.Tensor:
        """The inner process's loss on the encoded ``x0`` (and, with
        ``encode_cond``, the encoded ``cond``). ``noise`` is latent-shaped;
        ``t`` the inner process's time draw."""
        return self.diffusion.train_loss(model_fn, self.encode(x0), generator=generator,
                                         cond=self._cond(cond, encode_cond), y=y,
                                         noise=noise, t=t)

    def _decode_out(self, out: DiffusionOutput) -> DiffusionOutput:
        inter = out.intermediates
        if inter is not None:  # [K, N, h, w, zc] -> [K, N, H, W, C]
            flat = self.decode(inter.reshape((-1,) + tuple(inter.shape[2:])))
            inter = flat.reshape(tuple(inter.shape[:2]) + tuple(flat.shape[1:]))
        return DiffusionOutput(x=self.decode(out.x), intermediates=inter)

    def ddpm_sample(self, model_fn: DenoiseFn, n_samples: int, *, cond=None, y=None,
                    encode_cond: Optional[bool] = None, **kw) -> DiffusionOutput:
        c = self._cond(cond, encode_cond)
        return self._decode_out(self.diffusion.ddpm_sample(model_fn, n_samples, cond=c, y=y,
                                                           **kw))

    def ddim_sample(self, model_fn: DenoiseFn, n_samples: int, *, cond=None, y=None,
                    encode_cond: Optional[bool] = None, uncond=None, **kw) -> DiffusionOutput:
        c = self._cond(cond, encode_cond)
        # the CFG uncond image rides the first stage exactly like cond
        u = self._cond(uncond, encode_cond)
        return self._decode_out(self.diffusion.ddim_sample(model_fn, n_samples, cond=c, y=y,
                                                           uncond=u, **kw))

    def dpm_sample(self, model_fn: DenoiseFn, n_samples: int, *, cond=None, y=None,
                   encode_cond: Optional[bool] = None, uncond=None, **kw) -> DiffusionOutput:
        """The inner chain's DPM-Solver++ in latent space, decoded; the CFG
        ``uncond`` image rides the first stage like ``cond``."""
        c, u = self._cond(cond, encode_cond), self._cond(uncond, encode_cond)
        return self._decode_out(self.diffusion.dpm_sample(model_fn, n_samples, cond=c, y=y,
                                                          uncond=u, **kw))

    def unipc_sample(self, model_fn: DenoiseFn, n_samples: int, *, cond=None, y=None,
                     encode_cond: Optional[bool] = None, uncond=None, **kw) -> DiffusionOutput:
        """The inner chain's UniPC in latent space, decoded."""
        c, u = self._cond(cond, encode_cond), self._cond(uncond, encode_cond)
        return self._decode_out(self.diffusion.unipc_sample(model_fn, n_samples, cond=c, y=y,
                                                            uncond=u, **kw))

    def sample(self, model_fn: DenoiseFn, n_samples: int, *, cond=None, y=None,
               encode_cond: Optional[bool] = None, uncond=None, **kw) -> DiffusionOutput:
        """The inner process's own sampler (the rectified-flow ODE, EDM's
        Heun, the bridge's posterior walk from the encoded source), in latent
        space, decoded. An ``uncond`` is encoded and passed on only when
        given: the bridge takes none."""
        c = self._cond(cond, encode_cond)
        if uncond is not None:
            kw["uncond"] = self._cond(uncond, encode_cond)
        return self._decode_out(self.diffusion.sample(model_fn, n_samples, cond=c, y=y, **kw))
