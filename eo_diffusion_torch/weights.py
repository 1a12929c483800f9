"""Weights for the port's UNet and DiT: from JAX params, from reference
checkpoints, or seeded random values.

Counterpart of ``eo_diffusion_tpu/tools/convert_ckpt.py`` (the port keeps its
own copy because that module imports the JAX model). The port's UNet uses
the reference's torch state-dict names and layouts, so:

* a reference ``.pt`` (``clouds_best.pt``-style ``{"model": sd, "model_ema":
  sd}``, with ``model.``/``module.`` prefixes, schedule buffers and the dead
  ``nout/act/conv_out`` head) loads after :func:`fix_legacy_dict` and
  dropping those extras (:func:`load_reference_checkpoint`);
* a flax param tree maps over with the transposes of
  ``params_to_state_dict`` (:func:`state_dict_from_jax_params`): conv HWIO ->
  OIHW, Dense ``[I, O]`` -> Linear ``[O, I]``, attention ``qkv``/``proj_out``
  -> Conv1d ``[O, I, 1]``, GroupNorm ``scale`` -> ``weight``; a dual-time
  (MeanFlow) UNet's ``time_embed_r0`` / ``time_embed_r2``, which the
  reference does not have, become ``time_embed_r.0`` / ``time_embed_r.2``,
  beside ``time_embed.0`` / ``.2``;
* a flax DiT tree maps by module name (:func:`dit_state_dict_from_jax_params`):
  ``block_{i}.qkv.kernel [I, O]`` -> ``block_{i}.qkv.weight [O, I]``, the
  label table's ``embedding`` -> ``label_embed.weight``, a dual-time DiT's
  ``r_embed_0`` / ``r_embed_1`` by the same names, and with
  ``context_dim`` each block's ``cross.to_q`` / ``cross.to_kv`` /
  ``cross.proj_out``;
* a flax ``ConvAutoencoder`` tree maps by module name too
  (:func:`ae_state_dict_from_jax_params`): conv HWIO -> OIHW, each
  ``enc_norm{i}`` / ``dec_norm{i}`` GroupNorm's ``scale`` -> ``weight``;
* a backbone whose torch modules carry the flax names (the DiT with its MoE
  blocks' ``moe.router`` and ``w_in / b_in / w_out / b_out`` with their
  leading E, ``SpadeUNet``, ``ConvNextUNet``, ``TinyUNet``) maps by
  :func:`flax_layout`, one entry a leaf by module type: a depthwise
  ``[k, k, 1, C]`` kernel -> ``[C, 1, k, k]`` like any conv, a transposed
  conv's kernel flipped in space -> ``[in, out, kh, kw]``;
* a UNet's ``{name}_xattn`` cross-attention (``context_dim``) maps to
  ``<layer>.xattn``, and a ``ControlNet``'s flax tree (its encoder copy under
  the UNet's flax names, ``hint_*``, ``zero_*``) to the port's by
  :func:`controlnet_layout`, whose ``keystr`` paths are also the keys of
  the JAX package's ``controlnet.npz``.

:func:`model_layout` gives any of those modules' layout, and
:func:`torch_transforms` the torch twins of an entry's numpy transforms, so
code that works on the device in flax's orientation (LoRA's deltas, Muon's
orthogonalised updates) carries tensors across without leaving the card.

:func:`randomize_parameters` fills any of the port's modules, the DiT
included, with seeded values.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from eo_diffusion_torch.models.autoencoder import AutoencoderConfig
from eo_diffusion_torch.models.dit import DiT, DiTConfig
from eo_diffusion_torch.models.encoder_unet import EncoderUNet, EncoderUNetConfig
from eo_diffusion_torch.models.moe import MoEMLP
from eo_diffusion_torch.models.unet import LayerSpec, UNetConfig, build_unet_plan
from eo_diffusion_torch.models.unet_convnext import ChannelLayerNorm
from eo_diffusion_torch.models.unet_spade import SpadeUNet, SpadeUNetConfig
from eo_diffusion_torch.nn.primitives import GroupNorm32, PointwiseConv1d

__all__ = [
    "fix_legacy_dict",
    "state_dict_from_jax_params",
    "dit_state_dict_from_jax_params",
    "ae_state_dict_from_jax_params",
    "encoder_unet_state_dict_from_jax_params",
    "backbone_state_dict_from_jax_params",
    "flax_layout",
    "flax_state_dict",
    "flax_shape",
    "model_layout",
    "torch_transforms",
    "unet_layout",
    "controlnet_layout",
    "keystr",
    "load_reference_checkpoint",
    "load_jax_train_state",
    "randomize_parameters",
]

_SCHEDULE_BUFFERS = {
    "betas", "alphas", "alphas_cumprod", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod",
}
_DEAD_PREFIXES = ("nout.", "conv_out.", "act.")


def fix_legacy_dict(d: Mapping) -> Dict[str, torch.Tensor]:
    """Normalize the reference's checkpoint-dict variants (``model``/
    ``state_dict`` nesting, ``module.``/``model.`` prefixes; data.py:373-387,
    inference.py:82-86) to a flat name -> tensor mapping."""
    if "model" in d and isinstance(d["model"], Mapping):
        d = d["model"]
    if "state_dict" in d and isinstance(d.get("state_dict"), Mapping):
        d = d["state_dict"]
    out = {}
    for k, v in d.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("model."):
            k = k[len("model."):]
        out[k] = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v.detach().cpu()
    return out


def load_reference_checkpoint(path: str, cfg: UNetConfig, use_ema: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` checkpoint (or the port's own saved state dict)
    as a float32 state dict for ``UNet(cfg)``. Prefers the EMA weights
    (``model_ema``) like the reference's sampling path (train.py:148-149)."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, Mapping) and use_ema and "model_ema" in raw:
        sd = fix_legacy_dict({"model": raw["model_ema"]})
    else:
        sd = fix_legacy_dict(raw)
    return {k: v.float() for k, v in sd.items()
            if k not in _SCHEDULE_BUFFERS and not k.startswith(_DEAD_PREFIXES)
            and not k.startswith("n_averaged")}


def _put(sd, prefix, weight, bias):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = weight, np.asarray(bias)


def _dense(sd, prefix, d):
    _put(sd, prefix, np.asarray(d["kernel"]).T, d["bias"])


def _conv(sd, prefix, d):
    _put(sd, prefix, np.asarray(d["kernel"]).transpose(3, 2, 0, 1), d["bias"])


def _gn(sd, prefix, d):
    _put(sd, prefix, np.asarray(d["GroupNorm_0"]["scale"]), d["GroupNorm_0"]["bias"])


# (flax -> torch, torch -> flax) of one leaf
_ID = (np.asarray, np.asarray)
_TRANSPOSE = (lambda a: np.asarray(a).T, lambda w: np.asarray(w).T)  # Dense [I, O] <-> [O, I]
_HWIO = (lambda a: np.asarray(a).transpose(3, 2, 0, 1),  # conv HWIO <-> OIHW
         lambda w: np.asarray(w).transpose(2, 3, 1, 0))
_CONV1D = (lambda a: np.asarray(a).T[:, :, None], lambda w: np.asarray(w)[:, :, 0].T)
# flax ConvTranspose (a correlation of the dilated input) <-> torch's
# [in, out, kh, kw], whose correlation kernel is the one flipped in space
_TCONV = (lambda a: np.flip(np.asarray(a), (0, 1)).transpose(2, 3, 0, 1),
          lambda w: np.flip(np.asarray(w).transpose(2, 3, 0, 1), (0, 1)))
# the torch twins of the pairs above, on tensors of any device, by name
# (flax -> torch, torch -> flax); the numpy pairs' to_flax names them
_TORCH = {
    "id": (lambda a: a, lambda w: w),
    "transpose": (lambda a: a.t(), lambda w: w.t()),
    "hwio": (lambda a: a.permute(3, 2, 0, 1), lambda w: w.permute(2, 3, 1, 0)),
    "conv1d": (lambda a: a.t()[:, :, None], lambda w: w[:, :, 0].t()),
    "tconv": (lambda a: a.flip((0, 1)).permute(2, 3, 0, 1),
              lambda w: w.permute(2, 3, 0, 1).flip((0, 1))),
}
_TWIN = {_ID[1]: "id", _TRANSPOSE[1]: "transpose", _HWIO[1]: "hwio", _CONV1D[1]: "conv1d",
         _TCONV[1]: "tconv"}


def torch_transforms(name: str):
    """``(to_torch, to_flax)`` on torch tensors for the transform ``name``
    (``_TWIN[entry's numpy to_flax]``): the same permutation (and flip) of
    the same values, differentiable, on the tensor's device."""
    return _TORCH[name]


def flax_shape(shape, to_flax) -> tuple:
    """The flax shape of a torch parameter of ``shape`` under its entry's
    ``to_flax`` (a zero-strided view: nothing is allocated)."""
    return tuple(to_flax(np.broadcast_to(np.float32(0), tuple(shape))).shape)


# module kind -> its leaves: (flax subpath, torch parameter, transforms)
_LEAVES = {
    "dense": ((("kernel",), "weight", _TRANSPOSE), (("bias",), "bias", _ID)),
    "conv": ((("kernel",), "weight", _HWIO), (("bias",), "bias", _ID)),
    "conv_nobias": ((("kernel",), "weight", _HWIO),),
    "conv1d": ((("kernel",), "weight", _CONV1D), (("bias",), "bias", _ID)),
    "tconv": ((("kernel",), "weight", _TCONV), (("bias",), "bias", _ID)),
    "gn": ((("GroupNorm_0", "scale"), "weight", _ID), (("GroupNorm_0", "bias"), "bias", _ID)),
    "embed": ((("embedding",), "weight", _ID),),
    "ln": ((("g",), "g", _ID), (("b",), "b", _ID)),
    "moe": tuple(((n,), n, _ID) for n in ("w_in", "b_in", "w_out", "b_out")),
}
# UNet layer kind -> (flax submodule, torch submodule, module kind)
_UNET_LAYER = {
    "conv": (((), "", "conv"),),
    "res": ((("in_norm",), "in_layers.0", "gn"), (("in_conv",), "in_layers.2", "conv"),
            (("emb_proj",), "emb_layers.1", "dense"), (("out_norm",), "out_layers.0", "gn"),
            (("out_conv",), "out_layers.3", "conv")),
    "attn": ((("norm",), "norm", "gn"), (("qkv",), "qkv", "conv1d"),
             (("proj_out",), "proj_out", "conv1d")),
    "down": ((("conv",), "op", "conv"),),
    "up": ((("conv",), "conv", "conv"),),
}
_SKIP = (("skip_conv",), "skip_connection", "conv")
_XATTN = ((("norm",), "norm", "gn"), (("to_q",), "to_q", "dense"), (("to_kv",), "to_kv", "dense"),
          (("proj_out",), "proj_out", "dense"))


def _entries(items, fprefix, tprefix):
    """Layout entries ``(flax path, torch name, to_torch, to_flax)`` of the
    modules ``items`` ((flax subpath, torch subname, kind), ...)."""
    out = []
    for fsub, tsub, kind in items:
        tp = ".".join(p for p in (tprefix, tsub) if p)
        for leaf, attr, (fwd, inv) in _LEAVES[kind]:
            out.append((fprefix + fsub + leaf, f"{tp}.{attr}" if tp else attr, fwd, inv))
    return out


def _layer_layout(spec: LayerSpec, fname: str, tprefix: str, context_dim: int = 0):
    """One UNet layer's layout: flax module ``fname``, torch ``tprefix``."""
    items = _UNET_LAYER[spec.kind]
    if spec.kind == "res" and spec.in_ch != spec.out_ch:
        items = items + (_SKIP,)
    out = _entries(items, (fname,), tprefix)
    if spec.kind == "attn" and context_dim:
        out += _entries(_XATTN, (f"{fname}_xattn",), f"{tprefix}.xattn")
    return out


def _get(d: Mapping, path):
    for part in path:
        d = d[part]
    return d


def _layer(sd, kind: str, d, prefix: str):
    """One UNet layer of kind ``kind`` (a ``LayerSpec.kind``) from its flax
    subtree ``d`` into ``sd`` under ``prefix``."""
    items = _UNET_LAYER[kind] + ((_SKIP,) if kind == "res" and "skip_conv" in d else ())
    for fpath, tname, fwd, _ in _entries(items, (), prefix):
        sd[tname] = fwd(_get(d, fpath))


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys: ``['params']['a']``."""
    return "".join(f"[{k!r}]" for k in path)


def _as_tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))  # a writable copy
            for k, v in sd.items()}


def _embeddings_layout(cfg):
    """The time MLP (and r's, and the label table) of a UNet or ControlNet."""
    out = _entries(((("time_embed_0",), "time_embed.0", "dense"),
                    (("time_embed_2",), "time_embed.2", "dense")), (), "")
    if getattr(cfg, "dual_time", False):
        out += _entries(((("time_embed_r0",), "time_embed_r.0", "dense"),
                         (("time_embed_r2",), "time_embed_r.2", "dense")), (), "")
    if cfg.num_classes is not None:
        out += _entries(((("label_emb",), "label_emb", "embed"),), (), "")
    return out


def unet_layout(cfg: UNetConfig):
    """Every parameter of ``UNet(cfg)``: ``(flax path, torch name, to_torch,
    to_flax)``; the reference's torch names (``input_blocks.{b}.{l}``, ...)
    beside the flax ones (``input_{b}_{l}``, ...)."""
    plan = build_unet_plan(cfg)
    out = _embeddings_layout(cfg)
    for bi, block in enumerate(plan.input_blocks):
        for li, spec in enumerate(block):
            out += _layer_layout(spec, f"input_{bi}_{li}", f"input_blocks.{bi}.{li}",
                                 cfg.context_dim)
    for li, spec in enumerate(plan.middle_block):
        out += _layer_layout(spec, f"middle_{li}", f"middle_block.{li}", cfg.context_dim)
    for bi, block in enumerate(plan.output_blocks):
        for li, spec in enumerate(block):
            out += _layer_layout(spec, f"output_{bi}_{li}", f"output_blocks.{bi}.{li}",
                                 cfg.context_dim)
    return out + _entries(((("out_norm",), "out.0", "gn"), (("out_conv",), "out.2", "conv")),
                          (), "")


def controlnet_layout(cfg: UNetConfig, hint_channels: int):
    """Every parameter of ``ControlNet(cfg, hint_channels)``: ``(flax path,
    torch name, to_torch, to_flax)``; the encoder copy under the UNet's
    names, the hint encoder and the zero convs under flax's."""
    plan = build_unet_plan(cfg)
    out = _embeddings_layout(cfg)
    out += _entries(tuple(((n,), n, "conv") for n in ("hint_0", "hint_1", "hint_out")), (), "")
    for bi, block in enumerate(plan.input_blocks):
        for li, spec in enumerate(block):
            out += _layer_layout(spec, f"input_{bi}_{li}", f"input_blocks.{bi}.{li}")
        out += _entries(((("zero_%d" % bi,), f"zero_{bi}", "conv"),), (), "")
    for li, spec in enumerate(plan.middle_block):
        out += _layer_layout(spec, f"middle_{li}", f"middle_block.{li}")
    return out + _entries(((("zero_middle",), "zero_middle", "conv"),), (), "")


def model_layout(module: nn.Module):
    """The layout of any module the converters know: a ``UNet``'s
    (:func:`unet_layout`), a ``ControlNet``'s (:func:`controlnet_layout`),
    else that of a module carrying the flax names (:func:`flax_layout`)."""
    from eo_diffusion_torch.models.controlnet import ControlNet
    from eo_diffusion_torch.models.unet import UNet

    if isinstance(module, ControlNet):
        return controlnet_layout(module.config, module.hint_channels)
    if isinstance(module, UNet):
        return unet_layout(module.config)
    return flax_layout(module)


def _from_layout(layout, params: Mapping, what: str) -> Dict[str, torch.Tensor]:
    p = params["params"] if "params" in params else params
    sd = {tname: fwd(_get(p, fpath)) for fpath, tname, fwd, _ in layout}
    if _leaves(p) != len(sd):
        raise KeyError(f"the flax tree has {_leaves(p)} leaves, the {what} {len(sd)} parameters")
    return _as_tensors(sd)


def state_dict_from_jax_params(params: Mapping, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """Flax ``UNet`` params (numpy arrays; with or without the ``"params"``
    level) -> the port's state dict (:func:`unet_layout`)."""
    return _from_layout(unet_layout(cfg), params, "UNet")


def encoder_unet_state_dict_from_jax_params(params: Mapping, cfg: EncoderUNetConfig
                                            ) -> Dict[str, torch.Tensor]:
    """Flax ``EncoderUNet`` params (numpy arrays; with or without the
    ``"params"`` level) -> the port's classifier state dict, module by module
    under the JAX names (``stem``, ``enc_{l}_{j}``, ``enc_attn_{l}_{j}``,
    ``down_{l}``, ``mid_0``, ``mid_1``, ``out_norm``, ``pool``, ``head``,
    ``time_embed_{0,2}``). Every leaf of the tree is mapped; anything else
    raises."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    _dense(sd, "time_embed_0", p["time_embed_0"])
    _dense(sd, "time_embed_2", p["time_embed_2"])
    _conv(sd, "stem", p["stem"])
    for kind, name in EncoderUNet(cfg).layers:
        _layer(sd, kind, p[name], name)
    _gn(sd, "out_norm", p["out_norm"])
    sd["pool.positional_embedding"] = p["pool"]["positional_embedding"]
    _dense(sd, "pool.qkv_proj", p["pool"]["qkv_proj"])
    _dense(sd, "pool.c_proj", p["pool"]["c_proj"])
    _dense(sd, "head", p["head"])
    if _leaves(p) != len(sd):
        raise KeyError(f"the flax tree has {_leaves(p)} leaves, the classifier {len(sd)} "
                       "parameters")
    return _as_tensors(sd)


def _leaves(d: Mapping) -> int:
    return sum(_leaves(v) if isinstance(v, Mapping) else 1 for v in d.values())


def _kind(m: nn.Module) -> str:
    if isinstance(m, nn.ConvTranspose2d):
        return "tconv"
    if isinstance(m, nn.Conv2d):
        return "conv" if m.bias is not None else "conv_nobias"
    if isinstance(m, PointwiseConv1d):
        return "conv1d"
    if isinstance(m, nn.Linear):
        return "dense"
    if isinstance(m, GroupNorm32):
        return "gn"
    if isinstance(m, nn.Embedding):
        return "embed"
    if isinstance(m, ChannelLayerNorm):
        return "ln"
    if isinstance(m, MoEMLP):
        return "moe"
    raise TypeError(f"no flax layout for {type(m).__name__}")


def flax_layout(module: nn.Module):
    """Every parameter of a module whose submodules carry the flax names:
    ``(flax path, torch name, to_torch, to_flax)``, by module type."""
    out = []
    for name, m in module.named_modules():
        if any(p is not None for p in m._parameters.values()):
            out += _entries(((tuple(name.split(".")) if name else (), "", _kind(m)),), (), name)
    return out


def flax_state_dict(module: nn.Module, params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (numpy arrays; with or without the ``"params"`` level) of
    the backbone ``module`` mirrors by name -> its state dict. Every leaf of
    the tree is mapped, and every parameter filled; anything else raises."""
    return _from_layout(flax_layout(module), params, type(module).__name__)


def _meta(cls, cfg) -> nn.Module:
    with torch.device("meta"):
        return cls(cfg)


def dit_state_dict_from_jax_params(params: Mapping, cfg: DiTConfig) -> Dict[str, torch.Tensor]:
    """Flax ``DiT`` params (numpy arrays; with or without the ``"params"``
    level) -> the port's DiT state dict, its MoE blocks included. Every leaf
    of the tree is mapped, and every parameter of ``DiT(cfg)`` filled;
    anything else raises."""
    return flax_state_dict(_meta(DiT, cfg), params)


def backbone_state_dict_from_jax_params(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The converter of ``cfg``'s backbone: a UNet, a DiT or a SpadeUNet."""
    if isinstance(cfg, DiTConfig):
        return dit_state_dict_from_jax_params(params, cfg)
    if isinstance(cfg, SpadeUNetConfig):
        return flax_state_dict(_meta(SpadeUNet, cfg), params)
    return state_dict_from_jax_params(params, cfg)


def ae_state_dict_from_jax_params(params: Mapping, cfg: AutoencoderConfig
                                  ) -> Dict[str, torch.Tensor]:
    """Flax ``ConvAutoencoder`` params (numpy arrays; with or without the
    ``"params"`` level) -> the port's AE state dict. Every leaf of the tree
    is mapped, and every parameter of ``ConvAutoencoder(cfg)`` filled;
    anything else raises."""
    p = params["params"] if "params" in params else params
    convs = ["enc_stem", *(f"enc_down{i}" for i in range(cfg.num_down)), "enc_out",
             "dec_stem", *(f"dec_up{i}" for i in range(cfg.num_down)), "dec_out"]
    norms = [*(f"enc_norm{i}" for i in range(cfg.num_down)), "enc_norm_out",
             *(f"dec_norm{i}" for i in range(cfg.num_down)), "dec_norm_out"]
    sd: Dict[str, np.ndarray] = {}
    for name in convs:
        sd[f"{name}.weight"] = np.asarray(p[name]["kernel"]).transpose(3, 2, 0, 1)
        sd[f"{name}.bias"] = p[name]["bias"]
    for name in norms:
        gn = p[name]["GroupNorm_0"]
        sd[f"{name}.weight"], sd[f"{name}.bias"] = gn["scale"], gn["bias"]
    if _leaves(p) != len(sd):
        raise KeyError(f"the flax tree has {_leaves(p)} leaves, the AE {len(sd)} parameters")
    return _as_tensors(sd)


def _partial_from_layout(layout, params: Mapping, want: Mapping) -> Dict[str, torch.Tensor]:
    """The leaves of a flax tree that an optax mask may have left out
    (``MaskedNode`` where another branch of ``multi_transform`` owns the
    leaf) as torch tensors by name: each entry whose leaf is an array of the
    parameter's flax shape (``want``: name -> torch shape)."""
    p = params["params"] if "params" in params else params
    out = {}
    for fpath, tname, fwd, inv in layout:
        try:
            leaf = _get(p, fpath)
        except (KeyError, TypeError, AttributeError):
            continue
        if hasattr(leaf, "shape") and tuple(leaf.shape) == flax_shape(want[tname], inv):
            out[tname] = torch.from_numpy(np.array(fwd(leaf), dtype=np.float32))
    return out


@torch.no_grad()
def load_jax_train_state(state, cfg: Union[UNetConfig, DiTConfig, SpadeUNetConfig],
                         params: Mapping,
                         ema_params: Mapping,
                         mu: Mapping = None, nu: Mapping = None, step: int = 0,
                         opt_step: int = None, momentum: Mapping = None):
    """Fill the port's train state (``train.trainer.TrainState``) from a JAX
    ``TrainState`` given as numpy arrays: ``params`` and ``ema_params`` (flax
    trees), Adam's first and second moments ``mu`` / ``nu`` (same trees; None
    leaves the optimizer fresh), the micro-step counter ``step`` and the
    number of optimizer updates ``opt_step`` (default ``step``). ``cfg`` is
    the backbone's config, a UNet's, a DiT's or a SpadeUNet's. Both trainers can then start
    from the same state, mid-run too.

    A Muon run (``TrainerConfig.optimizer == "muon"``, ``train/muon.py``)
    also passes its ``momentum`` tree; then ``mu`` / ``nu`` hold arrays only
    at the AdamW branch's leaves and ``momentum`` only at the Muon branch's
    (optax's ``multi_transform`` masks the rest), and each parameter's state
    goes to the group of the port's optimizer that owns it."""
    convert = backbone_state_dict_from_jax_params
    state.model.load_state_dict(convert(params, cfg), strict=True)
    state.ema_model.load_state_dict(convert(ema_params, cfg), strict=True)
    state.step = int(step)
    state.opt_step = int(step if opt_step is None else opt_step)
    if mu is None and momentum is None:
        return state
    named = dict(state.model.named_parameters())
    if momentum is None:
        mu_sd, nu_sd = (convert(m, cfg) for m in (mu, nu))
        buf_sd = {}
    else:
        layout = model_layout(state.model)
        shapes = {n: tuple(p.shape) for n, p in named.items()}
        mu_sd, nu_sd, buf_sd = (_partial_from_layout(layout, t, shapes)
                                for t in (mu, nu, momentum))
    for name, prm in named.items():
        if name in buf_sd:
            state.optimizer.state[prm] = {"momentum_buffer": buf_sd[name].to(prm.device)}
        else:
            state.optimizer.state[prm] = {
                "step": torch.tensor(float(state.opt_step)),
                "exp_avg": mu_sd[name].to(prm.device),
                "exp_avg_sq": nu_sd[name].to(prm.device),
            }
    return state


@torch.no_grad()
def randomize_parameters(module: nn.Module, seed: int) -> nn.Module:
    """Overwrite every parameter with seeded values (numpy generator, in
    ``named_parameters`` order, so CPU and GPU copies agree). Weights draw
    N(0, 1/fan_in) (an MoE expert's ``[E, fan_in, out]`` weight too), biases
    N(0, 0.05^2) (an expert's ``[E, out]`` bias too) and norm scales 1 +
    N(0, 0.05^2). Unlike a fresh init this leaves no zero-initialized output
    layer, so a forward pass exercises every block."""
    rng = np.random.default_rng(seed)
    for name, prm in module.named_parameters():
        shape = tuple(prm.shape)
        if name.endswith((".w_in", ".w_out")):
            vals = rng.normal(size=shape) / np.sqrt(shape[1])
        elif prm.ndim >= 2 and not name.endswith((".b_in", ".b_out")):
            fan_in = int(np.prod(shape[1:])) if "label_emb" not in name else 1
            vals = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name.endswith(("weight", ".g")):
            vals = 1.0 + 0.05 * rng.normal(size=shape)
        else:
            vals = 0.05 * rng.normal(size=shape)
        prm.copy_(torch.from_numpy(vals.astype(np.float32)))
    return module
