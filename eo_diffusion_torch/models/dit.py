"""DiT: the diffusion transformer backbone in PyTorch.

Counterpart of ``eo_diffusion_tpu/models/dit.py`` (Peebles & Xie,
arXiv:2212.09748): patchify -> ``depth`` pre-LN transformer blocks with
adaLN-Zero conditioning -> unpatchify. Tensors are NHWC at the call, like the
UNet's, and the call surface is the UNet's: ``(x, t, cond=None, y=None)``
with channel-concat ``cond`` and class labels ``y``.

* Patchify flattens each patch in (py, px, c) order, ``[N, g, p, g, p, C] ->
  [N, T, p*p*C]``, and unpatchify inverts it, as the JAX package does, so
  ``patch_embed`` / ``final_proj`` weights carry over unchanged.
* Every block's self-attention goes through
  :func:`~eo_diffusion_torch.ops.attention.attention_from_qkv` in the
  (q|k|v)-major head order (``new_order=True``): on the card the fused-qkv
  kernel (K1) for the DiT's aligned token counts, e.g. T 1024 / D 64 at
  ``dit256``.
* Parameters are float32; the projections compute in ``DiTConfig.dtype``
  while the conditioning path (timestep MLP, label table, adaLN
  projections) stays float32, where the JAX package puts each cast.
* ``ada_mod``, ``final_mod`` and ``final_proj`` start at zero (adaLN-Zero), so
  a fresh DiT outputs zeros; tests randomise every parameter.
* ``context_dim > 0`` gives every block a cross-attention over ``context``
  tokens ``[N, L, context_dim]`` (:class:`CrossAttentionTokens`, JAX
  ``models/dit.py:127-154``) between its self-attention and its MLP. The JAX
  side is an einsum with no Pallas kernel behind it, so the port's is plain
  PyTorch too.

Submodule names follow the flax modules (``block_{i}.qkv``, ``t_embed_0``,
...), so :func:`eo_diffusion_torch.weights.dit_state_dict_from_jax_params`
maps a flax tree by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from eo_diffusion_torch.nn.primitives import Dense, ZeroDense, timestep_embedding
from eo_diffusion_torch.ops.attention import attention_from_qkv

__all__ = ["DiTConfig", "DiT", "DiTBlock", "CrossAttentionTokens", "posemb_sincos_2d",
           "modulated_ln", "patchify", "unpatchify", "dit_s", "dit_b"]


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """The JAX ``DiTConfig`` (``models/dit.py:45``); the options of later
    slices are kept so configs carry over, and the model raises on them."""

    image_size: int
    in_channels: int
    out_channels: int
    patch_size: int = 4
    hidden_size: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    num_classes: Optional[int] = None
    class_dropout_prob: float = 0.0
    dtype: torch.dtype = torch.float32  # compute dtype (params stay float32)
    attn_impl: str = "auto"  # "auto" (the kernel on CUDA) | "plain"
    # > 0: every block cross-attends to context tokens of this width
    context_dim: int = 0
    # later slices of the port; the constructor raises when one leaves its JAX default
    num_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 2
    moe_capacity: float = 1.25
    tome_ratio: float = 0.0
    tome_mlp: bool = False
    # MeanFlow's two times: t comes in packed [N, 2] = (t, r), and r gets an
    # embedding MLP of its own (r_embed_0 / r_embed_1) added to t's
    dual_time: bool = False

    @property
    def label_vocab(self) -> Optional[int]:
        if self.num_classes is None:
            return None
        return self.num_classes + (1 if self.class_dropout_prob > 0 else 0)

    @property
    def grid(self) -> int:
        assert self.image_size % self.patch_size == 0, (self.image_size, self.patch_size)
        return self.image_size // self.patch_size

    @property
    def tokens(self) -> int:
        return self.grid * self.grid


# option -> (the ROADMAP queue that ports it, the JAX default it must keep)
_LATER = {"num_experts": (13, 0), "moe_top_k": (13, 1),
          "moe_every": (13, 2), "moe_capacity": (13, 1.25), "tome_ratio": (13, 0.0),
          "tome_mlp": (13, False)}


def posemb_sincos_2d(h: int, w: int, dim: int) -> torch.Tensor:
    """Fixed 2D sin-cos positions ``[h*w, dim]`` float32: the first half of
    the channels encodes the row, the second the column."""
    assert dim % 4 == 0, dim
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    return torch.cat([timestep_embedding(ys.reshape(-1), dim // 2),
                      timestep_embedding(xs.reshape(-1), dim // 2)], dim=-1)


def modulated_ln(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis (no affine, float32 statistics, eps
    1e-6), then ``x * (1 + scale) + shift`` with ``[N, C]`` scale and shift;
    returns x's dtype."""
    normed = F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6)
    return (normed * (1.0 + scale[:, None, :]) + shift[:, None, :]).to(x.dtype)


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """``[N, H, W, C] -> [N, (H/p)*(W/p), p*p*C]``, each patch in (py, px, c)
    order."""
    n, h, w, c = x.shape
    tok = x.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return tok.reshape(n, (h // p) * (w // p), p * p * c)


def unpatchify(tok: torch.Tensor, p: int, grid: int) -> torch.Tensor:
    """Inverse of :func:`patchify` on a square ``grid``: ``[N, g*g, p*p*C] ->
    [N, g*p, g*p, C]``."""
    n = tok.shape[0]
    c = tok.shape[-1] // (p * p)
    out = tok.reshape(n, grid, grid, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, grid * p, grid * p, c)


class CrossAttentionTokens(nn.Module):
    """Cross-attention from tokens ``[N, T, hidden]`` to context tokens
    ``[N, L, context_dim]`` (JAX ``CrossAttentionTokens``,
    ``models/dit.py:127``): a plain LayerNorm (f32 statistics, eps 1e-6),
    ``to_q`` and ``to_kv``, q and k each scaled by ``1/sqrt(sqrt(ch))``, an
    f32 softmax, and a zero-initialised ``proj_out``, so a fresh module adds
    exactly zero."""

    def __init__(self, hidden: int, heads: int, context_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.to_q = Dense(hidden, hidden, dtype=dtype)
        self.to_kv = Dense(context_dim, 2 * hidden, dtype=dtype)
        self.proj_out = ZeroDense(hidden, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        heads = self.heads
        ch = d // heads
        zeros = torch.zeros(b, d, dtype=torch.float32, device=x.device)
        h = modulated_ln(x, zeros, zeros)
        q = self.to_q(h).reshape(b, t, heads, ch)
        kv = self.to_kv(context.to(h.dtype)).reshape(b, context.shape[1], 2, heads, ch)
        k, v = kv[:, :, 0], kv[:, :, 1]
        # 1 / ch**0.25 with the root rounded to the compute dtype, as in JAX
        scale = 1.0 / torch.tensor(float(ch)).sqrt().sqrt().to(q.dtype)
        w = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
        w = torch.softmax(w.float(), dim=-1).to(v.dtype)
        a = torch.einsum("bhts,bshc->bthc", w, v).reshape(b, t, d)
        return self.proj_out(a)


class DiTBlock(nn.Module):
    """Pre-LN transformer block with adaLN-Zero conditioning (JAX
    ``DiTBlock``, ``models/dit.py:157``): six modulation vectors from
    ``ada_mod``; attention ``qkv`` -> ``attention_from_qkv(new_order=True)``
    -> ``proj_out``, gated; with ``context_dim`` the ungated cross-attention
    ``cross``; MLP ``mlp_in`` -> tanh GELU -> ``mlp_out``, gated."""

    def __init__(self, hidden: int, heads: int, mlp_ratio: float,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 context_dim: int = 0):
        super().__init__()
        self.heads, self.attn_impl = heads, attn_impl
        mlp = int(hidden * mlp_ratio)
        self.ada_mod = ZeroDense(hidden, 6 * hidden)
        self.qkv = Dense(hidden, 3 * hidden, dtype=dtype)
        self.proj_out = Dense(hidden, hidden, dtype=dtype)
        self.cross = (CrossAttentionTokens(hidden, heads, context_dim, dtype)
                      if context_dim else None)
        self.mlp_in = Dense(hidden, mlp, dtype=dtype)
        self.mlp_out = Dense(mlp, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        mod = self.ada_mod(F.silu(c.float()))
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = mod.chunk(6, dim=-1)
        h = modulated_ln(x, shift_a, scale_a)
        a = attention_from_qkv(self.qkv(h), self.heads, new_order=True, impl=self.attn_impl)
        x = x + gate_a[:, None, :].to(x.dtype) * self.proj_out(a)
        if self.cross is not None:
            assert context is not None, "context_dim > 0 requires context"
            x = x + self.cross(x, context)
        h = modulated_ln(x, shift_m, scale_m)
        h = self.mlp_out(F.gelu(self.mlp_in(h), approximate="tanh"))
        return x + gate_m[:, None, :].to(x.dtype) * h


class DiT(nn.Module):
    """Diffusion transformer denoiser (JAX ``DiT``, ``models/dit.py:233``):
    ``embed`` -> ``block_i`` x depth -> ``final``. ``forward(x, t, cond=None,
    y=None, context=None)`` takes x ``[N, H, W, C]``, timesteps ``[N]``
    (integer or fractional; ``[N, 2]`` = (t, r) with ``dual_time``), concat
    ``cond`` ``[N, H, W, Cc]``, labels ``y`` ``[N]`` and, with
    ``context_dim``, context tokens ``[N, L, context_dim]``; returns ``[N, H,
    W, out_channels]`` in the compute dtype."""

    def __init__(self, config: DiTConfig):
        super().__init__()
        cfg = self.config = config
        for name, (queue, default) in _LATER.items():
            if getattr(cfg, name) != default:
                raise NotImplementedError(
                    f"DiTConfig.{name} is not ported yet (ROADMAP queue {queue})")
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = Dense(p * p * cfg.in_channels, d, dtype=cfg.dtype)
        self.t_embed_0 = Dense(256, d)
        self.t_embed_1 = Dense(d, d)
        if cfg.dual_time:
            self.r_embed_0 = Dense(256, d)
            self.r_embed_1 = Dense(d, d)
        if cfg.num_classes is not None:
            self.label_embed = nn.Embedding(cfg.label_vocab, d)
        self.blocks = []
        for i in range(cfg.depth):
            block = DiTBlock(d, cfg.num_heads, cfg.mlp_ratio, cfg.dtype, cfg.attn_impl,
                             cfg.context_dim)
            self.add_module(f"block_{i}", block)  # the flax names
            self.blocks.append(block)
        self.final_mod = ZeroDense(d, 2 * d)
        self.final_proj = ZeroDense(d, p * p * cfg.out_channels, dtype=cfg.dtype)
        self.register_buffer("pos_embed", posemb_sincos_2d(cfg.grid, cfg.grid, d),
                             persistent=False)

    def set_impl(self, attn: str) -> "DiT":
        """Put every block's attention on its kernel (``"auto"``) or its plain
        version (``"plain"``)."""
        if attn not in ("auto", "plain"):
            raise ValueError(f"impl must be 'auto' or 'plain', got {attn!r}")
        for block in self.blocks:
            block.attn_impl = attn
        return self

    def embed(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Patchify (after the channel-concat ``cond``) and add the positions:
        ``[N, T, hidden]`` in the compute dtype."""
        cfg = self.config
        if cond is not None:
            x = torch.cat([x, cond.to(x.dtype)], dim=-1)
        n, hgt, wid, ch = x.shape
        assert hgt == wid == cfg.image_size, (x.shape, cfg.image_size)
        assert ch == cfg.in_channels, (ch, cfg.in_channels)
        h = self.patch_embed(patchify(x, cfg.patch_size))
        return h + self.pos_embed.to(h.dtype)[None]

    def condition(self, t: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Conditioning embedding ``[N, hidden]`` float32: the timestep MLP
        (with ``dual_time``, t packed ``[N, 2]`` = (t, r) and r's own MLP
        added), plus the label table (whose last row is the CFG null class
        when ``class_dropout_prob > 0``)."""
        if self.config.dual_time:
            assert t.ndim == 2 and t.shape[-1] == 2, (
                "dual_time models take timesteps packed as [N, 2] = (t, r)", t.shape)
            t, r = t[:, 0], t[:, 1]
        c = self.t_embed_1(F.silu(self.t_embed_0(timestep_embedding(t, 256))))
        if self.config.dual_time:
            c = c + self.r_embed_1(F.silu(self.r_embed_0(timestep_embedding(r, 256))))
        if self.config.num_classes is not None:
            assert y is not None, "class-conditional DiT requires y"
            c = c + self.label_embed(y)
        return c

    def final(self, h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """adaLN, the output projection and unpatchify: ``[N, T, hidden] ->
        [N, H, W, out_channels]``."""
        shift, scale = self.final_mod(F.silu(c)).chunk(2, dim=-1)
        out = self.final_proj(modulated_ln(h, shift, scale))
        return unpatchify(out, self.config.patch_size, self.config.grid)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.embed(x, cond)
        c = self.condition(t, y)
        for block in self.blocks:
            h = block(h, c, context)
        return self.final(h, c)


def dit_s(image_size: int, in_channels: int = 3, patch_size: int = 4, **kw) -> DiTConfig:
    """DiT-S/4: 384 wide, 12 blocks, 6 heads (about 33 M parameters)."""
    return DiTConfig(image_size=image_size, in_channels=in_channels,
                     out_channels=kw.pop("out_channels", in_channels), patch_size=patch_size,
                     hidden_size=384, depth=12, num_heads=6, **kw)


def dit_b(image_size: int, in_channels: int = 3, patch_size: int = 8, **kw) -> DiTConfig:
    """DiT-B/8: 768 wide, 12 blocks, 12 heads (about 130 M parameters)."""
    return DiTConfig(image_size=image_size, in_channels=in_channels,
                     out_channels=kw.pop("out_channels", in_channels), patch_size=patch_size,
                     hidden_size=768, depth=12, num_heads=12, **kw)
