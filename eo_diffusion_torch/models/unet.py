"""OpenAI-style UNet denoiser in PyTorch (counterpart of ``eo_diffusion_tpu/models/unet.py``).

The architecture comes from the same static :class:`UNetPlan` as the JAX
package (a copy of :func:`build_unet_plan`, which mirrors the reference
constructor ``unet_openai.py:607-744`` block for block). Submodules carry the
reference's torch state-dict names (``time_embed.0``,
``input_blocks.N.M.in_layers.0``, ``.qkv``, ``.proj_out``, ``out.2``, ...), so
a reference ``clouds_best.pt`` state dict loads with ``load_state_dict`` and
no renaming (see :mod:`eo_diffusion_torch.weights`).

Activations are NHWC ``[N, H, W, C]``, like the JAX package; parameters are
float32 and each layer computes in ``UNetConfig.dtype`` (bf16 on the sampling
path), with GroupNorm statistics and softmax in float32. Self-attention goes
through :func:`eo_diffusion_torch.ops.attention.attention_from_qkv`, and
every GroupNorm, with the SiLU and the FiLM scale-shift that follow it
folded in, through :func:`eo_diffusion_torch.ops.group_norm.fused_group_norm`;
both launch their CUDA kernels on the card. :meth:`UNet.set_impl` puts
either on its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from eo_diffusion_torch.nn.primitives import (
    Conv,
    Dense,
    GroupNorm32,
    PointwiseConv1d,
    ZeroConv,
    avg_pool_2d,
    nearest_upsample_2d,
    timestep_embedding,
)
from eo_diffusion_torch.ops.attention import attention_from_qkv

__all__ = [
    "UNetConfig",
    "UNet",
    "build_unet_plan",
    "UNetPlan",
    "LayerSpec",
    "unet_eo_train",
    "unet_clouds",
    "unet_big",
    "unet_std",
    "unet_small",
]


# ---------------------------------------------------------------------------
# Config + plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Mirrors the reference ``UNetModel.__init__`` surface (unet_openai.py:553-575)."""

    image_size: int
    in_channels: int
    model_channels: int
    out_channels: int
    num_res_blocks: int
    attention_resolutions: Tuple[int, ...] = ()
    time_emb_factor: int = 4
    dropout: float = 0.0
    channel_mult: Tuple[int, ...] = (1, 2, 4, 8)
    conv_resample: bool = True
    num_classes: Optional[int] = None
    use_checkpoint: bool = False  # recompute each ResBlock's forward in the backward
    num_heads: int = 1
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_new_attention_order: bool = False
    dtype: torch.dtype = torch.float32  # compute dtype (params stay float32)
    attn_impl: str = "auto"  # "auto" (the kernel on CUDA) | "plain"
    # a later slice of the port; the constructor raises when it is set
    context_dim: int = 0
    class_dropout_prob: float = 0.0  # > 0 adds the CFG null-class row
    # MeanFlow's two times: timesteps come in packed [N, 2] = (t, r), and r
    # gets an embedding MLP of its own (time_embed_r) added to t's
    dual_time: bool = False
    # a later slice of the port; the constructor raises when it is set
    freeu: Optional[Tuple[float, float, float, float]] = None

    def __post_init__(self):
        object.__setattr__(self, "attention_resolutions", tuple(self.attention_resolutions))
        object.__setattr__(self, "channel_mult", tuple(self.channel_mult))

    @property
    def label_vocab(self) -> Optional[int]:
        if self.num_classes is None:
            return None
        return self.num_classes + (1 if self.class_dropout_prob > 0 else 0)

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * self.time_emb_factor


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside a (TimestepEmbedSequential-equivalent) block."""

    kind: str  # "conv" | "res" | "attn" | "down" | "up"
    in_ch: int
    out_ch: int
    num_heads: int = 0
    up: bool = False
    down: bool = False
    ds: int = 1  # an attention block's downsample factor from the input


@dataclasses.dataclass(frozen=True)
class UNetPlan:
    """Static layer plan, shared by the model and the checkpoint loader."""

    input_blocks: Tuple[Tuple[LayerSpec, ...], ...]
    middle_block: Tuple[LayerSpec, ...]
    output_blocks: Tuple[Tuple[LayerSpec, ...], ...]
    out_ch: int  # channels entering the output head

    def sites(self, shallow_depth: Optional[int] = None) -> Tuple[int, int]:
        """(attention blocks, GroupNorm sites) of one forward, or of the
        ``shallow_depth`` outermost input and output blocks alone (a DeepCache
        partial call): two norms a ResBlock, one an attention block, and the
        output norm."""
        if shallow_depth is None:
            blocks = (*self.input_blocks, self.middle_block, *self.output_blocks)
        else:
            blocks = (*self.input_blocks[:shallow_depth], *self.output_blocks[-shallow_depth:])
        specs = [sp for blk in blocks for sp in blk]
        attn = sum(sp.kind == "attn" for sp in specs)
        return attn, 2 * sum(sp.kind == "res" for sp in specs) + attn + 1

    def attention_shapes(self, image_size: int) -> Tuple[Tuple[int, int], ...]:
        """(tokens T, head dim D) of every attention block of one forward at
        ``image_size`` px, in the forward's order."""
        return tuple(((image_size // sp.ds) ** 2, sp.out_ch // sp.num_heads)
                     for blk in (*self.input_blocks, self.middle_block, *self.output_blocks)
                     for sp in blk if sp.kind == "attn")


def _attn_heads(cfg: UNetConfig, ch: int, upsample: bool) -> int:
    if cfg.num_head_channels == -1:
        heads = cfg.num_heads_upsample if (upsample and cfg.num_heads_upsample != -1) else cfg.num_heads
    else:
        assert ch % cfg.num_head_channels == 0, (ch, cfg.num_head_channels)
        heads = ch // cfg.num_head_channels
    assert ch % heads == 0, (ch, heads)
    return heads


def build_unet_plan(cfg: UNetConfig) -> UNetPlan:
    """Replicates the block construction of reference ``unet_openai.py:607-744``."""
    ch = int(cfg.channel_mult[0] * cfg.model_channels)
    input_blocks = [(LayerSpec("conv", cfg.in_channels, ch),)]
    input_block_chans = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [LayerSpec("res", ch, int(mult * cfg.model_channels))]
            ch = int(mult * cfg.model_channels)
            if ds in cfg.attention_resolutions:
                layers.append(LayerSpec("attn", ch, ch, num_heads=_attn_heads(cfg, ch, False),
                                        ds=ds))
            input_blocks.append(tuple(layers))
            input_block_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            out_ch = ch
            if cfg.resblock_updown:
                input_blocks.append((LayerSpec("res", ch, out_ch, down=True),))
            else:
                input_blocks.append((LayerSpec("down", ch, out_ch),))
            ch = out_ch
            input_block_chans.append(ch)
            ds *= 2

    middle = (
        LayerSpec("res", ch, ch),
        LayerSpec("attn", ch, ch, num_heads=_attn_heads(cfg, ch, False), ds=ds),
        LayerSpec("res", ch, ch),
    )

    output_blocks = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_block_chans.pop()
            layers = [LayerSpec("res", ch + ich, int(cfg.model_channels * mult))]
            ch = int(cfg.model_channels * mult)
            if ds in cfg.attention_resolutions:
                layers.append(LayerSpec("attn", ch, ch, num_heads=_attn_heads(cfg, ch, True),
                                        ds=ds))
            if level and i == cfg.num_res_blocks:
                out_ch = ch
                if cfg.resblock_updown:
                    layers.append(LayerSpec("res", ch, out_ch, up=True))
                else:
                    layers.append(LayerSpec("up", ch, out_ch))
                ds //= 2
            output_blocks.append(tuple(layers))

    return UNetPlan(
        input_blocks=tuple(input_blocks),
        middle_block=middle,
        output_blocks=tuple(output_blocks),
        out_ch=ch,
    )


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class ResBlock(nn.Module):
    """Residual block (reference ``ResBlock``, unet_openai.py:274-385).

    GroupNorm32 -> SiLU -> conv3x3, timestep-embedding add (or FiLM
    scale-shift), GroupNorm32 -> SiLU -> dropout -> zero-init conv3x3, with a
    1x1 skip projection when channels change. ``up``/``down`` resample both
    branches between the first norm and conv. Each norm runs with its SiLU
    (and the FiLM scale-shift) folded in; the ``nn.SiLU`` entries stay in
    the ``Sequential`` modules so the state-dict names keep the reference's
    indices. With ``use_checkpoint`` the block keeps only its inputs for the
    backward and runs its forward again there (the JAX package's
    ``nn.remat``); the RNG state is restored, so dropout draws the same mask.
    """

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, dropout: float = 0.0,
                 use_scale_shift_norm: bool = False, up: bool = False,
                 down: bool = False, dtype: torch.dtype = torch.float32,
                 use_checkpoint: bool = False):
        super().__init__()
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.use_checkpoint = use_checkpoint
        self.in_layers = nn.Sequential(GroupNorm32(in_ch), nn.SiLU(),
                                       Conv(in_ch, out_ch, 3, dtype=dtype))
        emb_width = 2 * out_ch if use_scale_shift_norm else out_ch
        self.emb_layers = nn.Sequential(nn.SiLU(), Dense(emb_ch, emb_width, dtype=dtype))
        self.out_layers = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(), nn.Dropout(dropout),
                                        ZeroConv(out_ch, out_ch, 3, dtype=dtype))
        self.skip_connection = (nn.Identity() if out_ch == in_ch
                                else Conv(in_ch, out_ch, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(self._forward, x, emb, use_reentrant=False)
        return self._forward(x, emb)

    def _forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[0](x, act="silu")
        if self.up:
            h, x = nearest_upsample_2d(h), nearest_upsample_2d(x)
        elif self.down:
            h, x = avg_pool_2d(h), avg_pool_2d(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers(emb)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.out_layers[0](h, act="silu", scale=scale, shift=shift)
        else:
            h = self.out_layers[0](h + emb_out[:, None, None, :].to(h.dtype), act="silu")
        h = self.out_layers[3](self.out_layers[2](h))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Spatial self-attention (reference ``AttentionBlock``, unet_openai.py:388-433).

    The NHWC input is viewed as tokens ``[B, T, C]``; the fused ``qkv``
    projection feeds :func:`attention_from_qkv` in either reference head
    order, and the zero-init ``proj_out`` closes the residual.
    """

    def __init__(self, ch: int, num_heads: int, use_new_attention_order: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto"):
        super().__init__()
        self.num_heads, self.new_order, self.attn_impl = num_heads, use_new_attention_order, attn_impl
        self.norm = GroupNorm32(ch)
        self.qkv = PointwiseConv1d(ch, 3 * ch, dtype=dtype)
        self.proj_out = PointwiseConv1d(ch, ch, dtype=dtype, zero=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hgt, wid, c = x.shape
        xt = x.reshape(b, hgt * wid, c)
        qkv = self.qkv(self.norm(xt))
        a = attention_from_qkv(qkv, self.num_heads, new_order=self.new_order,
                               impl=self.attn_impl)
        return (xt + self.proj_out(a)).reshape(b, hgt, wid, c)


class Upsample(nn.Module):
    """2x nearest upsample + optional conv (reference unet_openai.py:211-242)."""

    def __init__(self, ch: int, out_ch: int, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(ch, out_ch, 3, dtype=dtype) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nearest_upsample_2d(x)
        return self.conv(x) if self.conv is not None else x


class Downsample(nn.Module):
    """Stride-2 conv or avg-pool downsample (reference unet_openai.py:245-271)."""

    def __init__(self, ch: int, out_ch: int, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not use_conv:
            assert ch == out_ch, (ch, out_ch)
        self.op = Conv(ch, out_ch, 3, stride=2, dtype=dtype) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x) if self.op is not None else avg_pool_2d(x)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def _make_layer(cfg: UNetConfig, spec: LayerSpec) -> nn.Module:
    if spec.kind == "conv":
        return Conv(spec.in_ch, spec.out_ch, 3, dtype=cfg.dtype)
    if spec.kind == "res":
        return ResBlock(spec.in_ch, spec.out_ch, cfg.time_embed_dim, dropout=cfg.dropout,
                        use_scale_shift_norm=cfg.use_scale_shift_norm, up=spec.up,
                        down=spec.down, dtype=cfg.dtype, use_checkpoint=cfg.use_checkpoint)
    if spec.kind == "attn":
        return AttentionBlock(spec.out_ch, spec.num_heads, cfg.use_new_attention_order,
                              dtype=cfg.dtype, attn_impl=cfg.attn_impl)
    if spec.kind == "down":
        return Downsample(spec.in_ch, spec.out_ch, cfg.conv_resample, dtype=cfg.dtype)
    if spec.kind == "up":
        return Upsample(spec.in_ch, spec.out_ch, cfg.conv_resample, dtype=cfg.dtype)
    raise ValueError(spec.kind)


class UNet(nn.Module):
    """The timestep-embedded UNet (reference ``UNetModel``, unet_openai.py:522-780).

    ``forward(x, timesteps, cond=None, y=None)`` with x ``[N, H, W, C]``
    (NHWC), timesteps ``[N]`` (``[N, 2]`` = (t, r) with ``dual_time``), cond
    ``[N, H, W, Cc]`` channel-concat conditioning (unet_openai.py:754-756)
    and y ``[N]`` class labels whose
    embedding is added to the timestep embedding (:604-605, :764-766).
    Returns ``[N, H, W, out_channels]`` in x's dtype.
    """

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        for name, unset, queue in (("context_dim", cfg.context_dim == 0, 13),
                                   ("freeu", cfg.freeu is None, 13)):
            if not unset:
                raise NotImplementedError(
                    f"UNetConfig.{name} is not ported yet (ROADMAP queue {queue})")
        plan = build_unet_plan(cfg)
        ted, dt = cfg.time_embed_dim, cfg.dtype
        self.time_embed = nn.Sequential(Dense(cfg.model_channels, ted, dtype=dt), nn.SiLU(),
                                        Dense(ted, ted, dtype=dt))
        if cfg.dual_time:  # JAX time_embed_r0 / time_embed_r2
            self.time_embed_r = nn.Sequential(Dense(cfg.model_channels, ted, dtype=dt),
                                              nn.SiLU(), Dense(ted, ted, dtype=dt))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.label_vocab, ted)
        mk = lambda block: nn.ModuleList([_make_layer(cfg, s) for s in block])
        self.input_blocks = nn.ModuleList([mk(b) for b in plan.input_blocks])
        self.middle_block = mk(plan.middle_block)
        self.output_blocks = nn.ModuleList([mk(b) for b in plan.output_blocks])
        self.out = nn.Sequential(GroupNorm32(plan.out_ch), nn.SiLU(),
                                 ZeroConv(plan.out_ch, cfg.out_channels, 3, dtype=dt))

    def set_impl(self, attn: Optional[str] = None, norm: Optional[str] = None,
                 conv: Optional[str] = None) -> "UNet":
        """Put every attention block (``attn``), every GroupNorm (``norm``)
        and/or every 3x3 stride-1 conv's weight gradient (``conv``: through
        ``wgrad_route``) on its kernel (``"auto"``) or its plain version
        (``"plain"``: cuDNN's autograd); ``None`` leaves that kind as it
        is."""
        for impl in (attn, norm, conv):
            if impl not in (None, "auto", "plain"):
                raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
        for m in self.modules():
            if attn is not None and isinstance(m, AttentionBlock):
                m.attn_impl = attn
            if norm is not None and isinstance(m, GroupNorm32):
                m.impl = norm
            if conv is not None and isinstance(m, Conv):
                m.impl = conv
        return self

    @staticmethod
    def _run(block: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for layer in block:
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None, *,
                deep_cache: Optional[torch.Tensor] = None, return_deep: bool = False,
                cache_depth: Optional[int] = None):
        """The denoiser, with the DeepCache split (Ma et al., arXiv:2312.00858;
        JAX ``UNet.__call__``, ``models/unet.py:455-480``): the first
        ``cache_depth`` input blocks (default ``1 + num_res_blocks``, the
        full-resolution level) and the matching last output blocks are the
        shallow path; the rest (the downsampled levels, the middle block and
        every attention block of the clouds UNet) is the deep branch.

        * ``return_deep=True`` returns ``(out, deep)``, ``deep`` the feature
          entering the first shallow output block;
        * ``deep_cache=deep`` skips the deep branch and splices ``deep`` in:
          only the shallow blocks run, and ``partial(x, t, deep_cache=
          full(x, t).deep)`` equals ``full(x, t)`` bit for bit.
        """
        cfg = self.config
        if cond is not None:
            x = torch.cat([x, cond.to(x.dtype)], dim=-1)
        assert (y is not None) == (cfg.num_classes is not None), (
            "must specify y if and only if the model is class-conditional")
        assert x.shape[-1] == cfg.in_channels, (x.shape, cfg.in_channels)

        if cfg.dual_time:
            assert timesteps.ndim == 2 and timesteps.shape[-1] == 2, (
                "dual_time models take timesteps packed as [N, 2] = (t, r)", timesteps.shape)
            timesteps, r_times = timesteps[:, 0], timesteps[:, 1]
        emb = self.time_embed(timestep_embedding(timesteps, cfg.model_channels))
        if cfg.dual_time:
            emb = emb + self.time_embed_r(timestep_embedding(r_times, cfg.model_channels))
        if cfg.num_classes is not None:
            emb = emb + self.label_emb(y).to(emb.dtype)

        n_blocks = len(self.input_blocks)
        cd = cache_depth if cache_depth is not None else 1 + cfg.num_res_blocks
        use_cache = deep_cache is not None or return_deep
        if use_cache:
            assert 0 < cd < n_blocks, (cd, n_blocks)
        h = x.to(cfg.dtype)
        hs = []
        for block in (self.input_blocks[:cd] if deep_cache is not None else self.input_blocks):
            h = self._run(block, h, emb)
            hs.append(h)
        split = n_blocks - cd if use_cache else n_blocks
        deep = None
        if deep_cache is None:
            h = self._run(self.middle_block, h, emb)
            for block in self.output_blocks[:split]:
                h = torch.cat([h.to(cfg.dtype), hs.pop().to(cfg.dtype)], dim=-1)
                h = self._run(block, h, emb)
            deep = h
        else:
            h = deep_cache.to(cfg.dtype)
        for block in self.output_blocks[split:]:
            h = torch.cat([h.to(cfg.dtype), hs.pop().to(cfg.dtype)], dim=-1)
            h = self._run(block, h, emb)
        h = self.out[2](self.out[0](h, act="silu"))
        out = h.to(x.dtype)
        return (out, deep) if return_deep else out


# ---------------------------------------------------------------------------
# Factory presets
# ---------------------------------------------------------------------------


def _preset_mults(image_size: int) -> Tuple[int, ...]:
    if image_size == 128:
        return (1, 1, 2, 3, 4)
    if image_size == 64:
        return (1, 2, 3, 4)
    if image_size in (32, 28):
        return (1, 2, 2, 2)
    raise ValueError(f"unsupported image size: {image_size}")


def _preset_attn_ds(image_size: int) -> Tuple[int, ...]:
    res = "28,14,7" if image_size == 28 else "32,16,8"
    return tuple(image_size // int(r) for r in res.split(","))


def unet_eo_train(image_size: int = 64, in_channels: int = 3, out_channels: int = 3,
                  base_dim: int = 128, num_classes: Optional[int] = None,
                  dtype: torch.dtype = torch.float32) -> UNetConfig:
    """The reference train.py:50 config: base 128, mults [1,2,3,4], no
    attention, 1 res-block, 1 head."""
    return UNetConfig(
        image_size=image_size, in_channels=in_channels, model_channels=base_dim,
        out_channels=out_channels, num_res_blocks=1, attention_resolutions=(),
        channel_mult=(1, 2, 3, 4), num_heads=1, num_classes=num_classes, dtype=dtype,
    )


def unet_clouds(image_size: int = 64, in_channels: int = 3, out_channels: int = 3,
                num_classes: Optional[int] = None,
                dtype: torch.dtype = torch.float32) -> UNetConfig:
    """The published clouds checkpoint config (reference configs/Configs.txt:20-23):
    base 128, mults [1,2,3,4], attention at ds 4/8, 2 res-blocks, 8 heads."""
    return UNetConfig(
        image_size=image_size, in_channels=in_channels, model_channels=128,
        out_channels=out_channels, num_res_blocks=2, attention_resolutions=(4, 8),
        channel_mult=(1, 2, 3, 4), num_heads=8, num_classes=num_classes, dtype=dtype,
    )


def _preset(image_size: int, base_width: int, num_res_blocks: int, head_ch: int,
            time_emb_factor: int = 4, in_channels: int = 3, out_channels: int = 3,
            num_classes: Optional[int] = None,
            dtype: torch.dtype = torch.float32) -> UNetConfig:
    return UNetConfig(
        image_size=image_size, in_channels=in_channels, model_channels=base_width,
        out_channels=out_channels, num_res_blocks=num_res_blocks,
        attention_resolutions=_preset_attn_ds(image_size), dropout=0.1,
        channel_mult=_preset_mults(image_size), num_classes=num_classes,
        num_heads=4, num_head_channels=head_ch, time_emb_factor=time_emb_factor,
        use_scale_shift_norm=True, resblock_updown=True,
        use_new_attention_order=True, dtype=dtype,
    )


def unet_big(image_size: int, **kw) -> UNetConfig:
    """Reference ``UNetBig`` preset (unet_openai.py:783-827)."""
    return _preset(image_size, base_width=kw.pop("base_width", 192), num_res_blocks=3, head_ch=64, **kw)


def unet_std(image_size: int, **kw) -> UNetConfig:
    """Reference ``UNet`` preset (unet_openai.py:830-874)."""
    return _preset(image_size, base_width=kw.pop("base_width", 64), num_res_blocks=3, head_ch=64, **kw)


def unet_small(image_size: int, **kw) -> UNetConfig:
    """Reference ``UNetSmall`` preset (unet_openai.py:877-922)."""
    return _preset(image_size, base_width=kw.pop("base_width", 32), num_res_blocks=2,
                   head_ch=32, time_emb_factor=2, **kw)
