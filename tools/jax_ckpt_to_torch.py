"""Convert a checkpoint the JAX package trained into one the PyTorch port reads.

    python tools/jax_ckpt_to_torch.py --preset sen12mscr256 \\
        --ckpt logs/run/steps_00010000 --out logs/run_torch/steps_00010000

The JAX training CLI saves orbax directories (``logs/<run>/steps_<n>``,
``best``); the port's ``--ckpt`` and ``train.checkpoint.restore_params``
read one ``torch.save`` file. This script restores the JAX checkpoint
with orbax (no template, as ``eo_diffusion_tpu.train.checkpoint.
restore_params`` does), holds its ``params`` and ``ema_params`` against the
shapes of the preset's JAX model (a checkpoint of another shape is
refused), converts both with the port's
``weights.backbone_state_dict_from_jax_params`` (UNet, DiT with its MoE
blocks, SPADE UNet), and writes ``{"model", "model_ema"}`` at ``--out``.
The backbone is the preset's, as the CLIs build it: ``--num_classes``, ``--class_dropout``, ``--model_base_dim`` and
``--image_size`` override the preset as there, and ``--cond_channels`` the
concat cond's channels (by default the image's, as on the image datasets
with a paired view; a SPADE preset's segmap has one). For a latent preset it
also converts the first stage the JAX run saved (``--ae_ckpt``, default
``ae`` beside ``--ckpt``: orbax ``params/`` and ``ae_meta.json``) with
``ae_state_dict_from_jax_params`` into ``ae`` beside ``--out``, the
``params.pt`` and ``ae_meta.json`` that ``ae_trainer.load_ae`` reads.

The optimizer state comes along, so that ``cli.train --ckpt <out>`` resumes
the run: the file is then the port's whole train state
(``TrainState.state_dict()``: the step counter, the number of updates and
the optimizer's state beside ``model`` / ``model_ema``). An AdamW run's
``mu`` / ``nu``; a ``--optimizer muon`` run's Muon momentum on the matrix
leaves and Adam's ``mu`` / ``nu`` on the rest (``train/muon.py``; resume
it with ``--optimizer muon``). An accumulation in flight (``--grad_accum``)
is not carried: the port starts the next accumulation afresh.

It imports both packages and runs on the CPU; neither package imports it.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def opt_trees(opt_state) -> dict:
    """The optimizer trees of a JAX ``TrainState.opt_state``, in memory
    (optax's named tuples) or restored without a template (dicts and lists):
    Adam's ``mu``, ``nu`` and ``count`` and, for a Muon run, the
    ``momentum`` tree (None where absent), whatever wraps them (clip,
    ``MultiSteps``, ``apply_if_finite``, ``multi_transform``)."""
    found = {}

    def walk(node):
        if hasattr(node, "_asdict"):
            node = node._asdict()
        if isinstance(node, dict):
            if "mu" in node and "nu" in node and "mu" not in found:
                found.update(mu=node["mu"], nu=node["nu"], count=node.get("count"))
            if "momentum" in node and "momentum" not in found:
                found["momentum"] = node["momentum"]
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(opt_state)
    return {k: found.get(k) for k in ("mu", "nu", "count", "momentum")}


def port_train_state(tcfg, params, ema_params, opt_state, step: int):
    """The port's train state (``train.trainer.TrainState``) of the JAX state
    ``params`` / ``ema_params`` / ``opt_state`` (numpy trees), its optimizer
    AdamW, or Muon with AdamW where ``opt_state`` holds a Muon momentum."""
    import copy

    import torch

    from eo_diffusion_torch.cli.presets import build_denoiser
    from eo_diffusion_torch.train.muon import MuonWithAdamW
    from eo_diffusion_torch.train.trainer import TrainState
    from eo_diffusion_torch.weights import load_jax_train_state

    trees = opt_trees(opt_state)
    model = build_denoiser(tcfg)
    ema = copy.deepcopy(model).requires_grad_(False)
    if trees["momentum"] is not None:
        optimizer = MuonWithAdamW(model, lr=0.0)
    else:
        optimizer = torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)
    count = trees["count"]
    return load_jax_train_state(
        TrainState(model, ema, optimizer), tcfg, params, ema_params, mu=trees["mu"],
        nu=trees["nu"], step=int(step), opt_step=None if count is None else int(count),
        momentum=trees["momentum"])


def convert(preset_name: str, ckpt: str, out: str, num_classes: int = 0,
            class_dropout: float = 0.0, model_base_dim=None, image_size=None,
            cond_channels=None, ae_ckpt=None) -> dict:
    """Convert ``ckpt`` (a JAX orbax training checkpoint of ``preset_name``)
    into the port's checkpoint file ``out``; returns ``{"out", "config",
    "ae", "optimizer"}``: the file, the port's backbone config, the converted
    first stage's directory (None for a pixel preset) and the optimizer the
    file's state is for ("adamw", "muon", or None when the checkpoint holds
    no optimizer state)."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    import torch

    from eo_diffusion_torch.cli import presets as TP
    from eo_diffusion_torch.weights import backbone_state_dict_from_jax_params as to_sd
    from eo_diffusion_tpu.cli import presets as JP

    jpre, tpre = JP.get_preset(preset_name), TP.get_preset(preset_name)
    for pre in (jpre, tpre):
        pre.image_size = image_size or pre.image_size
        pre.base_dim = model_base_dim or pre.base_dim
    n_cls = num_classes or tpre.num_classes or None
    drop = class_dropout or tpre.class_dropout
    grid_ch = tpre.latent_channels if tpre.is_latent else tpre.in_channels
    if cond_channels is None:  # a concat cond as the CLIs build it on the image datasets
        cond_channels = {"concat": grid_ch, "spade": 1}.get(tpre.cond_type, 0)
    # the template: the preset's JAX model, as the JAX sampling CLI builds it
    jcfg = jpre.model_config(num_classes=n_cls, bf16=False, cond_channels=cond_channels,
                             class_dropout_prob=drop)
    size = jcfg.image_size
    kw = {"cond": jnp.zeros((1, size, size, cond_channels))} if cond_channels else {}
    if n_cls:
        kw["y"] = jnp.zeros((1,), jnp.int32)
    template = jax.eval_shape(JP.build_denoiser(jcfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, size, size, grid_ch)), jnp.zeros((1,)), **kw)
    raw = ocp.StandardCheckpointer().restore(os.path.abspath(ckpt))
    params, ema_params = raw["params"], raw["ema_params"]
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    for tree in (params, ema_params):
        if shapes(tree) != shapes(template):
            raise SystemExit(f"{ckpt} does not hold {preset_name}'s model with "
                             f"{cond_channels} cond channels and num_classes {n_cls} "
                             "(check --cond_channels, --num_classes, --class_dropout, "
                             "--model_base_dim, --image_size)")
    tcfg = tpre.model_config(bf16=False, cond_channels=cond_channels, num_classes=n_cls,
                             class_dropout_prob=drop)
    as_np = lambda tree: jax.tree.map(np.asarray, tree)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    opt = opt_trees(raw.get("opt_state"))
    optimizer = None
    if opt["mu"] is not None:
        state = port_train_state(tcfg, as_np(params), as_np(ema_params),
                                 as_np(raw["opt_state"]), int(np.asarray(raw.get("step", 0))))
        torch.save(state.state_dict(), out)
        optimizer = "muon" if opt["momentum"] is not None else "adamw"
    else:
        torch.save({"model": to_sd(as_np(params), tcfg),
                    "model_ema": to_sd(as_np(ema_params), tcfg)}, out)
    ae_out = None
    if tpre.is_latent:
        ae_out = _convert_ae(ae_ckpt or os.path.join(os.path.dirname(os.path.abspath(ckpt)),
                                                     "ae"),
                             os.path.join(os.path.dirname(os.path.abspath(out)), "ae"))
    return {"out": out, "config": tcfg, "ae": ae_out, "optimizer": optimizer}


def _convert_ae(src: str, dst: str) -> str:
    """The JAX first stage at ``src`` into the port's layout at ``dst``."""
    import jax

    from eo_diffusion_torch.models.autoencoder import AutoencoderConfig, ConvAutoencoder
    from eo_diffusion_torch.train import ae_trainer as TAT
    from eo_diffusion_torch.weights import ae_state_dict_from_jax_params
    from eo_diffusion_tpu.train import ae_trainer as JAT

    jmodel, params, scale = JAT.load_ae(src)
    meta = {k: v for k, v in dataclasses.asdict(jmodel.config).items() if k != "dtype"}
    cfg = AutoencoderConfig(**meta)
    model = ConvAutoencoder(cfg)
    model.load_state_dict(ae_state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg),
                          strict=True)
    return TAT.save_ae(dst, cfg, model, scale)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", required=True, help="the preset the JAX run trained")
    ap.add_argument("--ckpt", required=True, help="the JAX orbax checkpoint directory")
    ap.add_argument("--out", required=True, help="the port's checkpoint file to write")
    ap.add_argument("--num_classes", type=int, default=0)
    ap.add_argument("--class_dropout", type=float, default=0.0)
    ap.add_argument("--model_base_dim", type=int, default=None)
    ap.add_argument("--image_size", type=int, default=None)
    ap.add_argument("--cond_channels", type=int, default=None,
                    help="the concat cond's channels (default: the image's, or the latent "
                         "grid's, for a concat preset; 0 otherwise)")
    ap.add_argument("--ae_ckpt", type=str, default=None,
                    help="latent presets: the JAX first stage (default: 'ae' beside --ckpt)")
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    res = convert(args.preset, args.ckpt, args.out, args.num_classes, args.class_dropout,
                  args.model_base_dim, args.image_size, args.cond_channels, args.ae_ckpt)
    print(f"wrote {res['out']}"
          + (f" (the train state, {res['optimizer']}'s state)" if res["optimizer"] else "")
          + (f" and the first stage {res['ae']}" if res["ae"] else ""))
    return res


if __name__ == "__main__":
    main()
