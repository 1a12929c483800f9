"""Named experiment presets for the port (the pixel-space UNet + DDPM part of
``eo_diffusion_tpu/cli/presets.py``).

Each recipe is selectable with ``--preset``; presets of the other families
(latent, DiT, flow, EDM, bridge, MeanFlow, SPADE, ...) raise and name the
ROADMAP queue that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
from eo_diffusion_torch.models.unet import UNet, UNetConfig

__all__ = ["Preset", "PRESETS", "get_preset", "build_denoiser", "build_process"]


@dataclasses.dataclass
class Preset:
    name: str
    dataset: str
    image_size: int
    in_channels: int
    base_dim: int
    dim_mults: Tuple[int, ...]
    attention_resolutions: Tuple[int, ...]
    num_res_blocks: int
    num_heads: int
    cond_type: Optional[str] = None
    num_classes: int = 0
    timesteps: int = 1000
    batch_size: int = 128
    objective: str = "eps"

    def unet_config(self, bf16: bool = True, cond_channels: int = 0) -> UNetConfig:
        return UNetConfig(
            image_size=self.image_size,
            in_channels=self.in_channels + cond_channels,
            model_channels=self.base_dim,
            out_channels=self.in_channels,
            num_res_blocks=self.num_res_blocks,
            attention_resolutions=self.attention_resolutions,
            channel_mult=self.dim_mults,
            num_heads=self.num_heads,
            num_classes=self.num_classes or None,
            dtype=torch.bfloat16 if bf16 else torch.float32,
        )


PRESETS = {
    # reference train.py:50 active default (base 128, no attention, 1 res-block)
    "eurosat64": Preset("eurosat64", "eurosat", 64, 3, 128, (1, 2, 3, 4), (), 1, 1),
    # configs/Configs.txt:20-23: the published clouds recipe (RePaint "sum")
    "clouds64-attn": Preset("clouds64-attn", "clouds", 64, 3, 128, (1, 2, 3, 4), (4, 8), 2, 8,
                            cond_type="sum"),
    # reference inference.py:60 variant (mults 1,2,4,8)
    "inria64": Preset("inria64", "inria", 64, 3, 128, (1, 2, 4, 8), (), 1, 1),
    "oscd64": Preset("oscd64", "oscd", 64, 3, 128, (1, 2, 3, 4), (4, 8), 2, 8),
    # SEN12MS-CR cloud removal: p(clear | cloudy), the cloudy view as concat
    # conditioning (256 px native patches)
    "sen12mscr256": Preset("sen12mscr256", "sen12mscr", 256, 3, 128, (1, 2, 3, 4),
                           (4, 8), 2, 8, cond_type="concat", batch_size=16),
    "synthetic64": Preset("synthetic64", "synthetic", 64, 3, 64, (1, 2, 3, 4), (4, 8), 1, 4),
    # tiny smoke configs for CPU runs; tiny-cr is sen12mscr256 in miniature
    "tiny": Preset("tiny", "synthetic", 8, 3, 32, (1, 2), (), 1, 1,
                   timesteps=50, batch_size=16),
    "tiny-cr": Preset("tiny-cr", "synthetic", 8, 3, 32, (1, 2), (), 1, 1,
                      cond_type="concat", timesteps=50, batch_size=16),
}

# presets of the JAX package that later slices port, by ROADMAP queue
_LATER = {
    "mnist": 7,
    "vpred64": 11, "tiny-vpred": 11, "edm64": 11, "tiny-edm": 11,
    "bridge64": 11, "tiny-bridge": 11, "cddpm64": 11, "tiny-cddpm": 11,
    "latent64": 10, "tiny-latent": 10, "dit64": 10, "dit256": 10, "latent256": 10,
    "latent256-cr": 10, "tiny-latent-cr": 10, "tiny-latent-dit": 10, "flow64": 10,
    "cflow64": 10, "tiny-cflow": 10, "tiny-dit": 10, "tiny-dit4": 10,
    "tiny-dit-edm": 10, "tiny-flow": 10, "tiny-latent-flow": 10,
    "tiny-latent-bridge": 10,
    "meanflow64": 12, "tiny-meanflow": 12, "cmeanflow64": 12, "tiny-cmeanflow": 12,
    "tiny-dit-meanflow": 12,
    "spade64": 13, "tiny-spade": 13, "moe-dit64": 13, "tiny-moe": 13,
    "sr64-256": 14, "tiny-sr": 14,
}


def get_preset(name: str) -> Preset:
    if name in _LATER:
        raise NotImplementedError(
            f"preset {name!r} is not ported yet (ROADMAP queue {_LATER[name]})")
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return dataclasses.replace(PRESETS[name])


def build_denoiser(model_cfg: UNetConfig) -> UNet:
    """Instantiate the backbone for a config built by Preset.unet_config."""
    assert isinstance(model_cfg, UNetConfig), type(model_cfg)
    return UNet(model_cfg)


def build_process(preset: Preset, timesteps: int, image_size: int,
                  cond_type: Optional[str] = None) -> GaussianDiffusion:
    """The DDPM process for the preset at ``image_size``."""
    return GaussianDiffusion.create(timesteps=timesteps, image_size=image_size,
                                    in_channels=preset.in_channels, cond_type=cond_type,
                                    objective=preset.objective)
