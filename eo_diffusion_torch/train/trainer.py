"""Training loop on one device: train step, EMA, periodic sampling.

Counterpart of the single-device part of ``eo_diffusion_tpu/train/trainer.py``
(itself a re-design of the reference's imperative trainer, ``train.py:45-157``).
One :meth:`Trainer.step` is an eager PyTorch step: loss, ``backward()``, the
optimizer and the EMA update, in that order. What it keeps of the JAX trainer:

* AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, decoupled weight
  decay **1e-4** on every parameter), its learning rate set once per
  optimizer step from the dense ``warmup_cos_exp`` table;
* ``grad_clip``: global-norm clip of what reaches AdamW; the ``grad_norm``
  metric is the norm of the raw gradients;
* ``grad_accum``: ``k`` micro-steps average into one update; ``state.step``
  counts micro-steps, the LR table is indexed by optimizer step, and the EMA
  runs every ``model_ema_steps * grad_accum`` micro-steps;
* ``skip_nonfinite``: the outermost wrap. An update with any non-finite
  gradient is dropped (parameters, moments and the accumulation untouched),
  ``notfinite_count`` counts the bad updates in a row, and past 100 in a row
  it stops masking so that a diverged run fails loudly;
* the EMA tail: decay ``adjusted_decay(...)`` warmed by
  ``n = step // ema_every``, applied when ``step % ema_every == 0`` on the
  step before it is incremented.

The process is the DDPM chain (:class:`GaussianDiffusion`), rectified flow
(:class:`FlowMatching`), EDM (:class:`EDMProcess`), the Brownian bridge
(:class:`BrownianBridge`, whose concat cond is also its endpoint) or MeanFlow
(:class:`MeanFlow`, on a dual-time backbone; its loss takes a
``torch.func.jvp`` through the model), in pixels or wrapped in
:class:`LatentDiffusion` (a frozen first stage encodes the batch, previews
decode), the backbone a UNet or a DiT: the loss goes through the process's
``train_loss`` as in JAX's ``loss_fn``. A flow, EDM, bridge or MeanFlow
process previews with its own ``.sample`` (``preview_sampler="flow"``).
CFG-integrated MeanFlow (``cfg_omega != 1``) owns its label dropout, so the
trainer's own is off for it (JAX ``train/trainer.py:340-347``). The
backbone is built from its config for the grid it sees (the latent grid for a
latent process), so :meth:`init` encodes nothing. Checkpoints carry
``{"model", "model_ema", "opt_state", "step", ...}``
(:mod:`eo_diffusion_torch.train.checkpoint`); a first stage is saved apart
(:mod:`eo_diffusion_torch.train.ae_trainer`). The sharded and pipelined
layouts of the JAX trainer (fsdp, tp, sp, ep, pp), the Muon optimizer and
MoE backbones belong to later slices of the port; the constructor raises
for them and names the ROADMAP queue.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from eo_diffusion_torch.diffusion.bridge import BrownianBridge
from eo_diffusion_torch.diffusion.edm import EDMProcess
from eo_diffusion_torch.diffusion.flow import FlowMatching
from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
from eo_diffusion_torch.diffusion.latent import LatentDiffusion
from eo_diffusion_torch.diffusion.meanflow import MeanFlow
from eo_diffusion_torch.train.ema import adjusted_decay, ema_update_every, warmed_decay
from eo_diffusion_torch.train.lr_schedules import set_lr, warmup_cos_exp

__all__ = ["TrainState", "Trainer", "TrainerConfig"]

# optax.apply_if_finite(max_consecutive_errors=100) in the JAX trainer
_MAX_CONSECUTIVE_ERRORS = 100


@dataclasses.dataclass
class TrainerConfig:
    """CLI-facing knobs; names mirror the reference flags (train.py:22-42)."""

    lr: float = 1e-3
    batch_size: int = 128
    epochs: int = 100
    timesteps: int = 1000
    model_ema_steps: int = 10
    model_ema_decay: float = 0.995
    log_freq: int = 10
    n_samples: int = 16
    no_clip: bool = False
    num_classes: int = 0
    cond_type: Optional[str] = None
    ckpt_dir: str = "logs/run"
    sample_dir: str = "results/run"
    sample_every: int = 1000
    warmup_epochs: int = 10
    seed: int = 0
    # k micro-steps average into one optimizer update (reference lucidrains
    # trainer's gradient_accumulate_every)
    grad_accum: int = 1
    # the sharded layouts, MoE and Muon: later slices of the port, with the
    # JAX defaults; the Trainer raises when one leaves its default
    fsdp: bool = False
    fsdp_min_size: int = 2**16
    tp: bool = False
    ep: bool = False
    sp: bool = False
    moe_aux_weight: float = 0.01
    optimizer: str = "adamw"
    muon_lr_mult: float = 1.0
    # drop updates with a non-finite gradient instead of poisoning the run
    skip_nonfinite: bool = False
    # global-norm gradient clipping (0 = off, reference parity)
    grad_clip: float = 0.0
    # periodic-preview sampler (Trainer.sample): the reference previews with
    # the full DDPM chain; "ddim" with ~50 steps is far cheaper at 256 px;
    # "dpm" is DPM-Solver++(2M); "flow" is the native sampler of a flow, EDM
    # or bridge process (its ``.sample``)
    preview_sampler: str = "ddpm"  # "ddpm" | "ddim" | "dpm" | "flow"
    preview_steps: int = 50
    # the pipeline schedule: a later slice of the port
    pp_micro: int = 0
    pp_virtual: int = 1


# option -> the ROADMAP queue that ports it
_LATER = {"fsdp": 16, "fsdp_min_size": 16, "tp": 16, "sp": 16, "ep": 16, "pp_micro": 16,
          "pp_virtual": 16, "moe_aux_weight": 13, "muon_lr_mult": 14}


class TrainState:
    """Everything a step reads and writes: the model, its EMA copy, the
    optimizer, the micro-step counter, and what gradient accumulation and
    ``skip_nonfinite`` carry between steps."""

    def __init__(self, model: nn.Module, ema_model: nn.Module,
                 optimizer: torch.optim.Optimizer):
        self.model, self.ema_model, self.optimizer = model, ema_model, optimizer
        self.step = 0        # micro-steps taken
        self.opt_step = 0    # optimizer updates applied: the LR table's index
        self.mini_step = 0   # micro-steps inside the current accumulation
        self.acc_grads: Optional[List[torch.Tensor]] = None
        self.notfinite_count = 0   # bad updates in a row
        self.total_notfinite = 0

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    @property
    def ema_params(self) -> List[torch.Tensor]:
        return list(self.ema_model.parameters())

    def state_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "model_ema": self.ema_model.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "step": self.step, "opt_step": self.opt_step, "mini_step": self.mini_step,
            "acc_grads": self.acc_grads,
            "notfinite_count": self.notfinite_count,
            "total_notfinite": self.total_notfinite,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        self.ema_model.load_state_dict(sd["model_ema"])
        self.optimizer.load_state_dict(sd["opt_state"])  # moves to the params' device
        self.step, self.opt_step = int(sd["step"]), int(sd["opt_step"])
        self.mini_step = int(sd["mini_step"])
        device = next(self.model.parameters()).device
        self.acc_grads = (None if sd["acc_grads"] is None
                          else [g.to(device) for g in sd["acc_grads"]])
        self.notfinite_count = int(sd["notfinite_count"])
        self.total_notfinite = int(sd["total_notfinite"])


class Trainer:
    """End-to-end training orchestrator.

    Usage::

        trainer = Trainer(cfg, unet, diffusion, steps_per_epoch, device)
        state = trainer.init()
        for batch in loader:
            state, metrics = trainer.step(state, batch)

    Randomness: timesteps, noise and the CFG label dropout come from one
    explicit ``torch.Generator`` on the device, seeded from ``cfg.seed``;
    the model's ``nn.Dropout`` layers draw from torch's global generator of
    the device, which :meth:`init` seeds from ``cfg.seed`` too.
    """

    def __init__(self, cfg: TrainerConfig, model: nn.Module,
                 diffusion: Union[GaussianDiffusion, FlowMatching, EDMProcess, BrownianBridge,
                                  MeanFlow, LatentDiffusion],
                 steps_per_epoch: int, device=None):
        for name, queue in _LATER.items():
            if getattr(cfg, name) != getattr(TrainerConfig, name):
                raise NotImplementedError(
                    f"TrainerConfig.{name} is not ported yet (ROADMAP queue {queue})")
        if cfg.optimizer != "adamw":
            raise NotImplementedError(
                f"optimizer {cfg.optimizer!r} is not ported yet (ROADMAP queue 14)")
        if getattr(getattr(model, "config", None), "num_experts", 0):
            raise NotImplementedError("MoE backbones are not ported yet (ROADMAP queue 13)")
        inner = diffusion.diffusion if isinstance(diffusion, LatentDiffusion) else diffusion
        if not isinstance(inner, (GaussianDiffusion, FlowMatching, EDMProcess, BrownianBridge,
                                  MeanFlow)):
            raise NotImplementedError(f"{type(inner).__name__} processes are not ported yet")
        if cfg.preview_sampler not in ("ddpm", "ddim", "dpm", "flow"):
            raise ValueError(f"unknown preview_sampler {cfg.preview_sampler!r}")
        # a flow, EDM, bridge or MeanFlow process samples with its own
        # .sample (the "flow" preview), a latent one too; flow times, EDM
        # sigmas and MeanFlow's (t, r) pairs are floats, the DDPM chain's and
        # the bridge's steps integers
        native = isinstance(inner, (FlowMatching, EDMProcess, BrownianBridge, MeanFlow))
        self.float_t = isinstance(inner, (FlowMatching, EDMProcess, MeanFlow))
        if native != (cfg.preview_sampler == "flow"):
            # the native samplers have no DDPM/DDIM chain, the DDPM process no .sample
            raise ValueError(f"preview_sampler {cfg.preview_sampler!r} does not sample a "
                             f"{type(inner).__name__} process (flow needs flow, and EDM "
                             f"and the bridge preview with it too)")
        self.cfg, self.model, self.diffusion = cfg, model, diffusion
        self.device = torch.device(device) if device is not None else (
            next(model.parameters()).device)

        self.grad_accum = max(cfg.grad_accum, 1)
        # the LR schedule advances once per *optimizer* step: with k-fold
        # accumulation the loader yields k micro-batches per update
        opt_steps_per_epoch = max(steps_per_epoch // self.grad_accum, 1)
        total_steps = max(opt_steps_per_epoch * cfg.epochs, 1)
        sched = warmup_cos_exp(cfg.lr, opt_steps_per_epoch, cfg.epochs,
                               warmup_epochs=min(cfg.warmup_epochs, cfg.epochs))
        self.lr_table = sched.table(total_steps)
        self.ema_decay = adjusted_decay(cfg.model_ema_decay, cfg.batch_size,
                                        cfg.model_ema_steps, cfg.epochs)
        # state.step counts micro-steps; keep the EMA cadence in optimizer
        # steps like the reference (train.py:122)
        self.ema_every = cfg.model_ema_steps * self.grad_accum
        self.class_conditional = cfg.num_classes > 0
        # the train step is the single owner of CFG label dropout (the
        # probability lives in the model's config, which allocates the null
        # row), except for CFG-integrated MeanFlow, whose loss owns it
        self.class_dropout_prob = (
            0.0 if getattr(inner, "cfg_omega", 1.0) != 1.0
            else getattr(getattr(model, "config", None), "class_dropout_prob", 0.0))
        # RePaint-"sum" conditioning is sampling-time only (model.py:52)
        self.use_cond = cfg.cond_type == "concat"
        self._gen: Optional[torch.Generator] = None

    # -- lifecycle -----------------------------------------------------------

    def init(self) -> TrainState:
        """Move the model to the device, copy it for the EMA, build AdamW
        and seed the generators."""
        cfg = self.cfg
        torch.manual_seed(cfg.seed)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        model = self.model.to(self.device)
        ema_model = copy.deepcopy(model).requires_grad_(False).eval()
        optimizer = torch.optim.AdamW(model.parameters(), lr=float(self.lr_table[0]),
                                      betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        return TrainState(model, ema_model, optimizer)

    def _to_device(self, a, dtype=None):
        if a is None:
            return None
        if not torch.is_tensor(a):
            a = np.asarray(a)
            a = torch.from_numpy(a if a.flags.writeable else a.copy())
        return a.to(device=self.device, dtype=dtype or torch.float32)

    def loss(self, state: TrainState, batch: dict) -> torch.Tensor:
        """The training loss of one batch: a dict with "image" [N,H,W,C] and
        optionally "cond", "label", a fixed "noise" (the paired eps of a
        ReFlow batch too) and fixed timesteps "t" (integer steps of the DDPM
        chain or the bridge, flow times in [0, 1], EDM sigmas or MeanFlow's
        ``[N, 2]`` (t, r) pairs; numpy arrays or tensors)."""
        cfg = self.cfg
        cond = self._to_device(batch.get("cond")) if self.use_cond else None
        y = (self._to_device(batch.get("label"), torch.long)
             if self.class_conditional else None)
        if y is not None and self.class_dropout_prob > 0.0:
            # CFG label dropout to the learned null class (index num_classes)
            drop = torch.rand(y.shape, generator=self._gen,
                              device=self.device) < self.class_dropout_prob
            y = torch.where(drop, torch.full_like(y, cfg.num_classes), y)
        model_fn = lambda x, t, c, yy: state.model(x, t, cond=c, y=yy)
        return self.diffusion.train_loss(
            model_fn, self._to_device(batch["image"]), generator=self._gen, cond=cond, y=y,
            noise=self._to_device(batch.get("noise")),
            t=self._to_device(batch.get("t"), torch.float32 if self.float_t else torch.long))

    def step(self, state: TrainState, batch: dict):
        """One micro-step: loss, backward, (clipped, accumulated, finite-
        checked) AdamW update and the EMA tail. Returns ``(state, metrics)``
        with ``loss`` and ``grad_norm`` as 0-dim tensors on the device."""
        cfg = self.cfg
        if self._gen is None:
            raise RuntimeError("call Trainer.init() first")
        state.model.train()
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        loss = self.loss(state, batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}

        apply = True
        if cfg.skip_nonfinite:
            finite = bool(torch.stack([g.isfinite().all() for g in grads]).all())
            state.notfinite_count = 0 if finite else state.notfinite_count + 1
            state.total_notfinite += 0 if finite else 1
            apply = finite or state.notfinite_count > _MAX_CONSECUTIVE_ERRORS
            metrics["notfinite_count"] = state.notfinite_count
        if apply:
            self._accumulate_and_update(state, params, grads)
        for p in params:
            p.grad = None

        d = warmed_decay(self.ema_decay, state.step // self.ema_every)
        ema_update_every(state.ema_params, state.params, d, state.step, self.ema_every)
        state.step += 1
        return state, metrics

    def _accumulate_and_update(self, state: TrainState, params, grads) -> None:
        """Running mean over ``grad_accum`` micro-steps, then clip + AdamW."""
        k = self.grad_accum
        if k > 1:
            if state.acc_grads is None:
                state.acc_grads = [torch.zeros_like(g) for g in grads]
            # acc += (g - acc) / (mini_step + 1): the mean so far
            torch._foreach_sub_(grads, state.acc_grads)
            torch._foreach_add_(state.acc_grads, grads, alpha=1.0 / (state.mini_step + 1))
            state.mini_step += 1
            if state.mini_step < k:
                return
            grads, state.acc_grads, state.mini_step = state.acc_grads, None, 0
        if self.cfg.grad_clip > 0.0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            coef = torch.where(norm < self.cfg.grad_clip, torch.ones_like(norm),
                               self.cfg.grad_clip / norm)
            torch._foreach_mul_(grads, coef)
        for p, g in zip(params, grads):
            p.grad = g
        set_lr(state.optimizer, self.lr_table, state.opt_step)
        state.optimizer.step()
        state.opt_step += 1

    def current_lr(self, step: int) -> float:
        """LR at a given *micro*-step (the table is indexed by optimizer step)."""
        return float(self.lr_table[min(step // self.grad_accum, len(self.lr_table) - 1)])

    # -- sampling with EMA weights (reference train.py:148-149) --------------
    #
    # EMA params average over an ~1/(1-decay)-step horizon; early in training
    # they still contain initialization noise and sample garbage while the raw
    # params already produce structure. Pass use_ema=False for early previews.

    @torch.inference_mode()
    def sample(self, state: TrainState, seed: int, n: Optional[int] = None,
               cond=None, y=None, use_ema: bool = True) -> torch.Tensor:
        """``n`` samples ``[n, H, W, C]`` float32 from the EMA (or raw)
        weights with ``cfg.preview_sampler``, seeded by ``seed``; a latent
        process's come out decoded, in pixels."""
        cfg = self.cfg
        n = n or cfg.n_samples
        model = (state.ema_model if use_ema else state.model).eval()
        model_fn = lambda x, t, c, yy: model(x, t, cond=c, y=yy)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        cond = self._to_device(cond)
        y = self._to_device(y, torch.long)
        if cfg.preview_sampler == "ddpm":
            return self.diffusion.ddpm_sample(model_fn, n, device=self.device, generator=gen,
                                              cond=cond, y=y, clip=not cfg.no_clip).x
        kw = dict(cond=cond, y=y)
        if cond is not None and self.diffusion.cond_type == "sum":
            # ddpm_sample splits the (gt|mask) concat itself; the DDIM and
            # flow RePaint paths take mask/x0 explicitly
            ci = self.diffusion.in_channels
            kw = dict(cond=None, y=y, x0=cond[..., :ci], mask=cond[..., ci:ci + 1])
        if cfg.preview_sampler == "flow":
            return self.diffusion.sample(model_fn, n, device=self.device, generator=gen,
                                         num_steps=cfg.preview_steps, **kw).x
        if cfg.preview_sampler == "dpm":
            return self.diffusion.dpm_sample(model_fn, n, device=self.device, generator=gen,
                                             num_steps=cfg.preview_steps,
                                             clip=not cfg.no_clip, **kw).x
        return self.diffusion.ddim_sample(model_fn, n, device=self.device, generator=gen,
                                          num_steps=cfg.preview_steps, clip=not cfg.no_clip,
                                          **kw).x
