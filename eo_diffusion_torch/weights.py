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
  ``enc_norm{i}`` / ``dec_norm{i}`` GroupNorm's ``scale`` -> ``weight``.

:func:`randomize_parameters` fills any of the port's modules, the DiT
included, with seeded values.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from eo_diffusion_torch.models.autoencoder import AutoencoderConfig
from eo_diffusion_torch.models.dit import DiTConfig
from eo_diffusion_torch.models.encoder_unet import EncoderUNet, EncoderUNetConfig
from eo_diffusion_torch.models.unet import UNetConfig, build_unet_plan

__all__ = [
    "fix_legacy_dict",
    "state_dict_from_jax_params",
    "dit_state_dict_from_jax_params",
    "ae_state_dict_from_jax_params",
    "encoder_unet_state_dict_from_jax_params",
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


def _conv1d(sd, prefix, d):
    _put(sd, prefix, np.asarray(d["kernel"]).T[:, :, None], d["bias"])


def _gn(sd, prefix, d):
    _put(sd, prefix, np.asarray(d["GroupNorm_0"]["scale"]), d["GroupNorm_0"]["bias"])


def _layer(sd, kind: str, d, prefix: str):
    """One UNet layer of kind ``kind`` (a ``LayerSpec.kind``) from its flax
    subtree ``d`` into ``sd`` under ``prefix``."""
    if kind == "conv":
        _conv(sd, prefix, d)
    elif kind == "res":
        _gn(sd, f"{prefix}.in_layers.0", d["in_norm"])
        _conv(sd, f"{prefix}.in_layers.2", d["in_conv"])
        _dense(sd, f"{prefix}.emb_layers.1", d["emb_proj"])
        _gn(sd, f"{prefix}.out_layers.0", d["out_norm"])
        _conv(sd, f"{prefix}.out_layers.3", d["out_conv"])
        if "skip_conv" in d:
            _conv(sd, f"{prefix}.skip_connection", d["skip_conv"])
    elif kind == "attn":
        _gn(sd, f"{prefix}.norm", d["norm"])
        _conv1d(sd, f"{prefix}.qkv", d["qkv"])
        _conv1d(sd, f"{prefix}.proj_out", d["proj_out"])
    elif kind == "down":
        _conv(sd, f"{prefix}.op", d["conv"])
    elif kind == "up":
        _conv(sd, f"{prefix}.conv", d["conv"])


def _as_tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))  # a writable copy
            for k, v in sd.items()}


def state_dict_from_jax_params(params: Mapping, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """Flax ``UNet`` params (numpy arrays; with or without the ``"params"``
    level) -> the port's state dict."""
    p = params["params"] if "params" in params else params
    plan = build_unet_plan(cfg)
    sd: Dict[str, np.ndarray] = {}
    _dense(sd, "time_embed.0", p["time_embed_0"])
    _dense(sd, "time_embed.2", p["time_embed_2"])
    if cfg.dual_time:
        _dense(sd, "time_embed_r.0", p["time_embed_r0"])
        _dense(sd, "time_embed_r.2", p["time_embed_r2"])
    if cfg.num_classes is not None:
        sd["label_emb.weight"] = np.asarray(p["label_emb"]["embedding"])
    for bi, block in enumerate(plan.input_blocks):
        for li, spec in enumerate(block):
            _layer(sd, spec.kind, p[f"input_{bi}_{li}"], f"input_blocks.{bi}.{li}")
    for li, spec in enumerate(plan.middle_block):
        _layer(sd, spec.kind, p[f"middle_{li}"], f"middle_block.{li}")
    for bi, block in enumerate(plan.output_blocks):
        for li, spec in enumerate(block):
            _layer(sd, spec.kind, p[f"output_{bi}_{li}"], f"output_blocks.{bi}.{li}")
    _gn(sd, "out.0", p["out_norm"])
    _conv(sd, "out.2", p["out_conv"])
    if _leaves(p) != len(sd):
        raise KeyError(f"the flax tree has {_leaves(p)} leaves, the UNet {len(sd)} parameters")
    return _as_tensors(sd)


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


def _dit_linears(cfg: DiTConfig):
    """The DiT's linear layers by name."""
    mods = ("ada_mod", "qkv", "proj_out", "mlp_in", "mlp_out")
    if cfg.context_dim:
        mods += ("cross.to_q", "cross.to_kv", "cross.proj_out")
    blocks = [f"block_{i}.{m}" for i in range(cfg.depth) for m in mods]
    times = ["t_embed_0", "t_embed_1", *(("r_embed_0", "r_embed_1") if cfg.dual_time else ())]
    return ["patch_embed", *times, *blocks, "final_mod", "final_proj"]


def dit_state_dict_from_jax_params(params: Mapping, cfg: DiTConfig) -> Dict[str, torch.Tensor]:
    """Flax ``DiT`` params (numpy arrays; with or without the ``"params"``
    level) -> the port's DiT state dict. Every leaf of the tree is mapped,
    and every parameter of ``DiT(cfg)`` filled; anything else raises."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    for name in _dit_linears(cfg):
        d = p
        for part in name.split("."):
            d = d[part]
        if set(d) != {"kernel", "bias"}:
            raise KeyError(f"{name}: expected kernel and bias, got {sorted(d)}")
        sd[f"{name}.weight"], sd[f"{name}.bias"] = np.asarray(d["kernel"]).T, d["bias"]
    if cfg.num_classes is not None:
        sd["label_embed.weight"] = p["label_embed"]["embedding"]
    if _leaves(p) != len(sd):
        raise KeyError(f"the flax tree has {_leaves(p)} leaves, the DiT {len(sd)} parameters")
    return _as_tensors(sd)


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


@torch.no_grad()
def load_jax_train_state(state, cfg: Union[UNetConfig, DiTConfig], params: Mapping,
                         ema_params: Mapping,
                         mu: Mapping = None, nu: Mapping = None, step: int = 0,
                         opt_step: int = None):
    """Fill the port's train state (``train.trainer.TrainState``) from a JAX
    ``TrainState`` given as numpy arrays: ``params`` and ``ema_params`` (flax
    trees), Adam's first and second moments ``mu`` / ``nu`` (same trees; None
    leaves the optimizer fresh), the micro-step counter ``step`` and the
    number of optimizer updates ``opt_step`` (default ``step``). ``cfg`` is
    the backbone's config, a UNet's or a DiT's. Both trainers can then start
    from the same state, mid-run too."""
    convert = (dit_state_dict_from_jax_params if isinstance(cfg, DiTConfig)
               else state_dict_from_jax_params)
    state.model.load_state_dict(convert(params, cfg), strict=True)
    state.ema_model.load_state_dict(convert(ema_params, cfg), strict=True)
    state.step = int(step)
    state.opt_step = int(step if opt_step is None else opt_step)
    if mu is not None:
        mu_sd, nu_sd = (convert(m, cfg) for m in (mu, nu))
        for name, prm in state.model.named_parameters():
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
    N(0, 1/fan_in), biases N(0, 0.05^2) and norm scales 1 + N(0, 0.05^2).
    Unlike a fresh init this leaves no zero-initialized output layer, so a
    forward pass exercises every block."""
    rng = np.random.default_rng(seed)
    for name, prm in module.named_parameters():
        shape = tuple(prm.shape)
        if prm.ndim >= 2:
            fan_in = int(np.prod(shape[1:])) if "label_emb" not in name else 1
            vals = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name.endswith("weight"):
            vals = 1.0 + 0.05 * rng.normal(size=shape)
        else:
            vals = 0.05 * rng.normal(size=shape)
        prm.copy_(torch.from_numpy(vals.astype(np.float32)))
    return module
