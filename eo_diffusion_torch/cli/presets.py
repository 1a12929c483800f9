"""Named experiment presets for the port (the UNet, DiT, MoE-DiT and SPADE
presets, DDPM, rectified flow, EDM, the Brownian bridge and MeanFlow, in
pixels or behind a first stage, of ``eo_diffusion_tpu/cli/presets.py``).

Each recipe is selectable with ``--preset``. A super-resolution preset
(``sr_factor > 0``: ``sr64-256``, ``tiny-sr``) conditions on the degraded
view of its own image (``data.transforms.sr_cond``) and is the second stage
of ``cli.cascade``. A ``backbone="spade"``
preset builds a :class:`SpadeUNet` whose cond is the segmentation map
(``--cond_type spade``; process-side that is ``concat``). A MeanFlow preset
builds a dual-time backbone whose attention is pinned to its plain version
(``attn_impl="plain"``, the JAX preset's ``"xla"``): MeanFlow's loss takes a
``torch.func.jvp`` through the model, and the attention kernels' Functions
have no forward-mode rule (the GroupNorm and conv kernels' have). A latent
preset (``latent_downs > 0``) is a two-stage recipe: a
:class:`ConvAutoencoder` first stage with ``2**latent_downs``
spatial reduction, then the backbone and the process on the
``latent_size``-square, ``latent_channels``-deep latent grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from eo_diffusion_torch.diffusion.bridge import BrownianBridge
from eo_diffusion_torch.diffusion.edm import EDMProcess
from eo_diffusion_torch.diffusion.flow import FlowMatching
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
from eo_diffusion_torch.diffusion.meanflow import MeanFlow
from eo_diffusion_torch.models.autoencoder import AutoencoderConfig
from eo_diffusion_torch.models.dit import DiT, DiTConfig
from eo_diffusion_torch.models.unet import UNet, UNetConfig
from eo_diffusion_torch.models.unet_spade import SpadeUNet, SpadeUNetConfig

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
    # latent diffusion (the CompVis LatentDiffusion slot, reference
    # diffusion/ddpm.py:628-692): latent_downs > 0 trains a ConvAutoencoder
    # first stage with 2**latent_downs spatial reduction, then diffuses the
    # [size/2**d]^2 x latent_channels grid and decodes samples to pixels
    latent_downs: int = 0
    latent_channels: int = 4
    ae_base_dim: int = 64
    ae_steps: int = 2000  # default first-stage training budget (cli/train.py)
    # backbone "dit" selects models/dit.DiT (base_dim is the hidden size,
    # depth the block count, patch_size the patchify stride), "spade"
    # models/unet_spade.SpadeUNet (the segmap modulates every norm); process "flow"
    # trains and samples diffusion/flow.FlowMatching, "edm"
    # diffusion/edm.EDMProcess, "bridge" diffusion/bridge.BrownianBridge and
    # "meanflow" diffusion/meanflow.MeanFlow (on a dual-time backbone)
    # instead of the DDPM chain
    backbone: str = "unet"  # "unet" | "dit" | "spade"
    patch_size: int = 4
    depth: int = 12
    process: str = "ddpm"  # "ddpm" | "flow" | "edm" | "bridge" | "meanflow"
    # CFG-integrated MeanFlow (paper section 4): omega > 1 trains the
    # omega-guided field, sampled with one conditional call. Needs classes
    mf_cfg_omega: float = 1.0
    # default CFG label dropout of a class-conditional preset (allocates the
    # null embedding row; the CLIs' --class_dropout overrides)
    class_dropout: float = 0.0
    objective: str = "eps"
    # Lin et al. 2023 (arXiv:2305.08891): rescale the schedule to SNR(T) = 0
    # (needs objective "v"); sample with --ddim_spacing trailing or dpm
    zero_terminal_snr: bool = False
    # Mixture-of-Experts DiT (models/moe.py): > 0 routes every moe_every-th
    # block's FFN over num_experts experts (top-k token choice)
    num_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 2
    # super-resolution stage: sr_factor > 0 makes this a concat-conditioned
    # SR model whose cond the CLIs derive from the image itself,
    # data.transforms.sr_cond(image, factor) (average-pool, nearest-upsample
    # back), so any dataset trains an SR stage, and cli.cascade chains it
    # behind a base preset whose image_size * sr_factor matches
    sr_factor: int = 0

    @property
    def is_latent(self) -> bool:
        return self.latent_downs > 0

    @property
    def latent_size(self) -> int:
        return self.image_size // (2 ** self.latent_downs)

    def _grid(self) -> Tuple[int, int]:
        """The model-facing grid (size, channels): pixels, or the latent grid."""
        if self.is_latent:
            return self.latent_size, self.latent_channels
        return self.image_size, self.in_channels

    def cond_channels(self, pixel_channels: int) -> int:
        """The backbone's channels of a concat cond of ``pixel_channels``: a
        latent preset encodes its cond, which then has latent_channels."""
        return self.latent_channels if self.is_latent else pixel_channels

    def model_config(self, bf16: bool = True, cond_channels: int = 0,
                     num_classes: Optional[int] = None,
                     class_dropout_prob: float = 0.0
                     ) -> Union[UNetConfig, DiTConfig, SpadeUNetConfig]:
        """The backbone config of the preset's family: :meth:`unet_config`,
        a :class:`DiTConfig` for ``backbone="dit"`` (with the preset's MoE
        fields) or a :class:`SpadeUNetConfig` for ``"spade"`` (the segmap's
        ``cond_channels`` are its label channels). A MeanFlow preset's is
        dual-time with its attention pinned to the plain version."""
        meanflow = self.process == "meanflow"
        pin = dict(dual_time=True, attn_impl="plain") if meanflow else {}
        if self.backbone == "unet":
            cfg = self.unet_config(bf16, cond_channels, num_classes, class_dropout_prob)
            return dataclasses.replace(cfg, **pin) if meanflow else cfg
        if self.backbone == "spade":
            # the segmap conditions spatially; the class embedding and CFG are not wired
            assert not num_classes and class_dropout_prob == 0.0, (
                "the SPADE backbone conditions on the segmap spatially; embedding-class "
                "conditioning/CFG are not wired")
            assert not self.is_latent, "spade presets are pixel-space"
            return SpadeUNetConfig(
                image_size=self.image_size,
                in_channels=self.in_channels,
                model_channels=self.base_dim,
                out_channels=self.in_channels,
                label_channels=max(cond_channels, 1),
                num_res_blocks=self.num_res_blocks,
                attention_resolutions=self.attention_resolutions,
                channel_mult=self.dim_mults,
                num_heads=self.num_heads,
                spade_hidden=min(128, 2 * self.base_dim),
                dtype=torch.bfloat16 if bf16 else torch.float32,
            )
        assert self.backbone == "dit", self.backbone
        size, chans = self._grid()
        return DiTConfig(
            image_size=size,
            in_channels=chans + cond_channels,
            out_channels=chans,
            patch_size=self.patch_size,
            hidden_size=self.base_dim,
            depth=self.depth,
            num_heads=self.num_heads,
            num_classes=num_classes or self.num_classes or None,
            class_dropout_prob=class_dropout_prob,
            dtype=torch.bfloat16 if bf16 else torch.float32,
            num_experts=self.num_experts,
            moe_top_k=self.moe_top_k,
            moe_every=self.moe_every,
            **pin,
        )

    def unet_config(self, bf16: bool = True, cond_channels: int = 0,
                    num_classes: Optional[int] = None,
                    class_dropout_prob: float = 0.0) -> UNetConfig:
        """The UNet sized to the model-facing grid: pixels, or the latent grid
        of a latent preset (in and out channels become latent_channels)."""
        size, chans = self._grid()
        return UNetConfig(
            image_size=size,
            in_channels=chans + cond_channels,
            model_channels=self.base_dim,
            out_channels=chans,
            num_res_blocks=self.num_res_blocks,
            attention_resolutions=self.attention_resolutions,
            channel_mult=self.dim_mults,
            num_heads=self.num_heads,
            num_classes=num_classes or self.num_classes or None,
            class_dropout_prob=class_dropout_prob,
            dtype=torch.bfloat16 if bf16 else torch.float32,
        )

    def ae_config(self, bf16: bool = False) -> AutoencoderConfig:
        """The first stage's config; float32 unless asked, as the CLIs use it."""
        assert self.is_latent, f"preset {self.name} is not a latent recipe"
        return AutoencoderConfig(
            in_channels=self.in_channels,
            latent_channels=self.latent_channels,
            base_channels=self.ae_base_dim,
            num_down=self.latent_downs,
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
    # MNIST digits at 28 px, one channel (reference data.py:24-40)
    "mnist": Preset("mnist", "mnist", 28, 1, 32, (1, 2, 2), (), 1, 1,
                    timesteps=1000, batch_size=128),
    # tiny smoke configs for CPU runs; tiny-cr is sen12mscr256 in miniature
    "tiny": Preset("tiny", "synthetic", 8, 3, 32, (1, 2), (), 1, 1,
                   timesteps=50, batch_size=16),
    "tiny-cr": Preset("tiny-cr", "synthetic", 8, 3, 32, (1, 2), (), 1, 1,
                      cond_type="concat", timesteps=50, batch_size=16),
    # DiT family: DiT-S/4 at 64 px (T 256, D 64), DDPM
    "dit64": Preset("dit64", "synthetic", 64, 3, 384, (), (), 0, 6, batch_size=64,
                    backbone="dit", patch_size=4, depth=12),
    # DiT-B/8 + rectified flow at 256 px (T 1024, D 64, 12 heads)
    "dit256": Preset("dit256", "synthetic", 256, 3, 768, (), (), 0, 12, batch_size=16,
                     backbone="dit", patch_size=8, depth=12, process="flow"),
    # rectified flow on the UNet
    "flow64": Preset("flow64", "synthetic", 64, 3, 64, (1, 2, 3, 4), (4, 8), 1, 4,
                     batch_size=64, process="flow"),
    "tiny-dit": Preset("tiny-dit", "synthetic", 16, 3, 64, (), (), 0, 4, timesteps=50,
                       batch_size=16, backbone="dit", patch_size=4, depth=2),
    "tiny-dit4": Preset("tiny-dit4", "synthetic", 16, 3, 64, (), (), 0, 4, timesteps=50,
                        batch_size=16, backbone="dit", patch_size=4, depth=4),
    "tiny-flow": Preset("tiny-flow", "synthetic", 8, 3, 32, (1, 2), (), 1, 1, batch_size=16,
                        process="flow"),
    # latent diffusion: 64 px images diffused as 16x16x4 latents behind a
    # trained ConvAutoencoder first stage
    "latent64": Preset("latent64", "synthetic", 64, 3, 64, (1, 2, 3), (2, 4), 2, 4,
                       timesteps=1000, batch_size=64, latent_downs=2, latent_channels=4,
                       ae_base_dim=64, ae_steps=3000),
    # tiny latent smoke config (CPU): 16 px pixels -> 8x8x4 latents
    "tiny-latent": Preset("tiny-latent", "synthetic", 16, 3, 32, (1, 2), (), 1, 1,
                          timesteps=50, batch_size=16, latent_downs=1, latent_channels=4,
                          ae_base_dim=16, ae_steps=60),
    # the production LDM configuration: an f4 ConvAE first stage at 256 px,
    # DiT-B/4 + rectified flow on the 64x64x4 latent grid (T 256, D 64)
    "latent256": Preset("latent256", "synthetic_hard", 256, 3, 768, (), (), 0, 12,
                        batch_size=32, backbone="dit", patch_size=4, depth=12,
                        process="flow", latent_downs=2, latent_channels=4, ae_base_dim=128,
                        ae_steps=6000),
    # cloud removal at the latent256 configuration: the cloudy view is
    # first-stage-encoded and channel-concatenated to the noisy latent
    "latent256-cr": Preset("latent256-cr", "synthetic_hard", 256, 3, 768, (), (), 0, 12,
                           cond_type="concat", batch_size=32, backbone="dit", patch_size=4,
                           depth=12, process="flow", latent_downs=2, latent_channels=4,
                           ae_base_dim=128, ae_steps=6000),
    "tiny-latent-cr": Preset("tiny-latent-cr", "synthetic", 16, 3, 64, (), (), 0, 4,
                             cond_type="concat", timesteps=50, batch_size=16, backbone="dit",
                             patch_size=2, depth=2, process="flow", latent_downs=2,
                             latent_channels=4, ae_base_dim=16, ae_steps=16),
    "tiny-latent-dit": Preset("tiny-latent-dit", "synthetic", 16, 3, 64, (), (), 0, 4,
                              timesteps=50, batch_size=16, backbone="dit", patch_size=2,
                              depth=2, process="flow", latent_downs=2, latent_channels=4,
                              ae_base_dim=16, ae_steps=16),
    # latent rectified flow (FlowMatching inside LatentDiffusion): 16 px
    # pixels -> 8x8x4 latents, ODE sampling in latent space
    "tiny-latent-flow": Preset("tiny-latent-flow", "synthetic", 16, 3, 32, (1, 2), (), 1, 1,
                               batch_size=16, process="flow", latent_downs=1,
                               latent_channels=4, ae_base_dim=16, ae_steps=60),
    # v-prediction on a zero-terminal-SNR schedule (arXiv:2305.08891)
    "vpred64": Preset("vpred64", "synthetic", 64, 3, 64, (1, 2, 3, 4), (4, 8), 1, 4,
                      objective="v", zero_terminal_snr=True),
    "tiny-vpred": Preset("tiny-vpred", "synthetic", 8, 3, 32, (1, 2), (), 1, 1, timesteps=50,
                         batch_size=16, objective="v", zero_terminal_snr=True),
    # class-conditional rectified flow and DDPM on the hard fixture, trained
    # with CFG label dropout and sampled with --guidance_scale
    "cflow64": Preset("cflow64", "synthetic_hard", 64, 3, 64, (1, 2, 3, 4), (4, 8), 1, 4,
                      batch_size=64, process="flow", num_classes=5, class_dropout=0.15),
    "tiny-cflow": Preset("tiny-cflow", "synthetic_hard", 8, 3, 32, (1, 2), (), 1, 1,
                         timesteps=50, batch_size=16, process="flow", num_classes=5,
                         class_dropout=0.15),
    "cddpm64": Preset("cddpm64", "synthetic_hard", 64, 3, 64, (1, 2, 3, 4), (4, 8), 1, 4,
                      batch_size=64, num_classes=5, class_dropout=0.15),
    "tiny-cddpm": Preset("tiny-cddpm", "synthetic_hard", 8, 3, 32, (1, 2), (), 1, 1,
                         timesteps=50, batch_size=16, num_classes=5, class_dropout=0.15),
    # EDM (Karras et al., arXiv:2206.00364): the sigma-space preconditioned
    # denoiser, sampled with Heun on the Karras grid (+ churn)
    "edm64": Preset("edm64", "synthetic", 64, 3, 64, (1, 2, 3, 4), (4, 8), 1, 4,
                    batch_size=64, process="edm"),
    "tiny-edm": Preset("tiny-edm", "synthetic", 8, 3, 32, (1, 2), (), 1, 1, batch_size=16,
                       process="edm"),
    # the DiT under the EDM objective and sampler
    "tiny-dit-edm": Preset("tiny-dit-edm", "synthetic", 16, 3, 64, (), (), 0, 4,
                           batch_size=16, backbone="dit", patch_size=4, depth=2,
                           process="edm"),
    # Brownian-bridge paired translation (BBDM, arXiv:2205.07680): sampling
    # starts at the cloudy source and walks the bridge posterior to the
    # clear target, the image-to-image form of the cloud-removal use case
    "bridge64": Preset("bridge64", "synthetic", 64, 3, 64, (1, 2, 3, 4), (4, 8), 1, 4,
                       cond_type="concat", batch_size=64, process="bridge"),
    "tiny-bridge": Preset("tiny-bridge", "synthetic", 8, 3, 32, (1, 2), (), 1, 1,
                          cond_type="concat", timesteps=50, batch_size=16, process="bridge"),
    # the bridge between the encoded endpoints, decoded (BBDM's LBBDM)
    "tiny-latent-bridge": Preset("tiny-latent-bridge", "synthetic", 16, 3, 32, (1, 2), (), 1,
                                 1, cond_type="concat", timesteps=50, batch_size=16,
                                 process="bridge", latent_downs=1, latent_channels=4,
                                 ae_base_dim=16, ae_steps=60),
    # MeanFlow (arXiv:2505.13447): a 1-4-call sampler trained from scratch,
    # on flow64's UNet
    "meanflow64": Preset("meanflow64", "synthetic", 64, 3, 64, (1, 2, 3, 4), (4, 8), 1, 4,
                         batch_size=64, process="meanflow"),
    "tiny-meanflow": Preset("tiny-meanflow", "synthetic", 8, 3, 32, (1, 2), (), 1, 1,
                            batch_size=16, process="meanflow"),
    # CFG-integrated MeanFlow: guided 1-call samples from one conditional call
    "cmeanflow64": Preset("cmeanflow64", "synthetic_hard", 64, 3, 64, (1, 2, 3, 4), (4, 8), 1,
                          4, batch_size=64, process="meanflow", num_classes=5,
                          mf_cfg_omega=2.0),
    "tiny-cmeanflow": Preset("tiny-cmeanflow", "synthetic_hard", 8, 3, 32, (1, 2), (), 1, 1,
                             batch_size=16, process="meanflow", num_classes=5,
                             mf_cfg_omega=2.0),
    # the dual-time DiT under MeanFlow
    "tiny-dit-meanflow": Preset("tiny-dit-meanflow", "synthetic", 16, 3, 64, (), (), 0, 4,
                                batch_size=16, backbone="dit", patch_size=4, depth=2,
                                process="meanflow"),
    # SPADE / SDM semantic-map conditioned generation: the dataset's
    # segmentation is the segmap that modulates every norm (cond_type "spade")
    "spade64": Preset("spade64", "synthetic", 64, 3, 64, (1, 2, 3, 4), (8,), 2, 4,
                      cond_type="spade", backbone="spade", batch_size=64),
    "tiny-spade": Preset("tiny-spade", "synthetic", 8, 3, 32, (1, 2), (), 1, 1,
                         cond_type="spade", backbone="spade", timesteps=50, batch_size=16),
    # Mixture-of-Experts DiT-S/4: 8 experts, top-2, in every second block
    "moe-dit64": Preset("moe-dit64", "synthetic", 64, 3, 384, (), (), 0, 6, batch_size=64,
                        backbone="dit", patch_size=4, depth=12, num_experts=8, moe_top_k=2),
    "tiny-moe": Preset("tiny-moe", "synthetic", 16, 3, 64, (), (), 0, 4, timesteps=50,
                       batch_size=16, backbone="dit", patch_size=4, depth=2, num_experts=4),
    # super-resolution stages: sr64-256 upsamples a 64 px base 4x at the clouds
    # UNet's widths (cascade partner: synthetic64); tiny-sr 2x from 8 px
    # (cascade partner: tiny)
    "sr64-256": Preset("sr64-256", "synthetic", 256, 3, 128, (1, 2, 3, 4), (4, 8), 2, 8,
                       cond_type="concat", batch_size=16, sr_factor=4),
    "tiny-sr": Preset("tiny-sr", "synthetic", 16, 3, 32, (1, 2), (), 1, 1, cond_type="concat",
                      timesteps=50, batch_size=16, sr_factor=2),
}

# presets of the JAX package that later slices port, by ROADMAP queue (none left)
_LATER = {}


def get_preset(name: str) -> Preset:
    if name in _LATER:
        raise NotImplementedError(
            f"preset {name!r} is not ported yet (ROADMAP queue {_LATER[name]})")
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return dataclasses.replace(PRESETS[name])


def build_denoiser(model_cfg: Union[UNetConfig, DiTConfig, SpadeUNetConfig]) -> nn.Module:
    """Instantiate the backbone for a config built by Preset.model_config."""
    if isinstance(model_cfg, DiTConfig):
        return DiT(model_cfg)
    if isinstance(model_cfg, SpadeUNetConfig):
        return SpadeUNet(model_cfg)
    assert isinstance(model_cfg, UNetConfig), type(model_cfg)
    return UNet(model_cfg)


def build_process(preset: Preset, timesteps: int, image_size: int,
                  cond_type: Optional[str] = None
                  ) -> Union[GaussianDiffusion, FlowMatching, EDMProcess, BrownianBridge,
                             MeanFlow]:
    """The preset's process on the model-facing grid (``image_size`` px, or
    the latent grid of a latent preset, which a caller wraps in
    ``LatentDiffusion``): the DDPM chain, rectified flow for ``process="flow"``
    or EDM for ``"edm"`` (where "sum" stays sampling-time inpainting and
    "concat" conditions the model), or the Brownian bridge for ``"bridge"``,
    whose cond must be "concat": the source image is the bridge's endpoint
    and the model's input; or MeanFlow for ``"meanflow"`` (conditioned as
    flow is; ``mf_cfg_omega != 1`` trains CFG-integrated against the null
    class ``num_classes``). ``cond_type="spade"`` is ``"concat"`` here: the
    segmap is pass-through conditioning; only how the CLIs build it and which
    backbone reads it differ."""
    size, chans = preset._grid() if preset.is_latent else (image_size, preset.in_channels)
    if cond_type == "spade":
        cond_type = "concat"
    if preset.process == "flow":
        return FlowMatching.create(image_size=size, in_channels=chans, cond_type=cond_type)
    if preset.process == "meanflow":
        kw = {}
        if preset.mf_cfg_omega != 1.0:
            assert preset.num_classes > 0, "mf_cfg_omega needs a class-conditional preset"
            kw = dict(cfg_omega=preset.mf_cfg_omega, cfg_null_index=preset.num_classes)
        return MeanFlow.create(image_size=size, in_channels=chans, cond_type=cond_type, **kw)
    if preset.process == "edm":
        return EDMProcess.create(image_size=size, in_channels=chans, cond_type=cond_type)
    if preset.process == "bridge":
        assert cond_type == "concat", (
            f"bridge presets are paired translation: cond_type must be 'concat' (the source "
            f"image), got {cond_type!r}")
        return BrownianBridge.create(image_size=size, in_channels=chans, timesteps=timesteps,
                                     cond_type=cond_type)
    assert preset.process == "ddpm", preset.process
    return GaussianDiffusion.create(timesteps=timesteps, image_size=size, in_channels=chans,
                                    cond_type=cond_type, objective=preset.objective,
                                    zero_terminal_snr=preset.zero_terminal_snr)
