"""Few-step distillation CLI of the port (``eo_diffusion_tpu.cli.distill``).

``python -m eo_diffusion_torch.cli.distill --preset flow64 --ckpt
logs/flow_run/best --steps 2000 --n_pairs 4096``

``python -m eo_diffusion_torch.cli.distill --preset synthetic64 --method
consistency --ckpt logs/run/best --steps 4000``

Four methods, each from a teacher checkpoint of ``cli.train`` (its EMA
weights, or the raw ones with ``--use_raw_params``) to a student checkpoint
``<--dir>/student`` that ``cli.inference --ckpt`` samples:

* ``reflow`` (flow presets; ``diffusion/distill.py``): simulate ``(eps,
  x1)`` couplings with the teacher's ODE, re-fit the model on the paired
  endpoints; sample with ``--sampler flow --flow_method euler
  --sampler_steps 1..4``;
* ``consistency`` (DDPM presets; ``diffusion/consistency.py``): data-free
  consistency distillation on a pool of teacher DDIM samples, the student
  against its slow-EMA target along teacher ODE steps; sample with
  ``--sampler cm`` (the same ``--cd_points`` and ``--sigma_data``);
* ``progressive`` (DDPM presets; ``diffusion/progressive.py``):
  ``--pd_rounds`` halving rounds from a ``--pd_base_steps`` teacher grid, v
  students; sample with ``--sampler pd --sampler_steps`` the final count;
* ``guided`` (class-conditional flow or DDPM presets): fold the CFG-combined
  teacher (``--guidance_scale``) into a single-call student: guided
  couplings re-fit (flow), or the guided eps regressed on a pool of guided
  teacher samples (DDPM).

Latent presets distill on the inner latent grid (couplings and pools are
latents; the first stage is not loaded here) and decode at inference through
``--ae_ckpt``. Runs on the GPU (``--device cuda``, the default) and exits
non-zero when there is none; ``--device cpu`` runs on the CPU. The student
trains with AdamW (weight decay 1e-4, as ``optax.adamw``) under the
warmup-cosine schedule of ``optax.warmup_cosine_decay_schedule``
(``train/lr_schedules.warmup_cosine_decay``: warmup ``steps // 20``, down to
``lr / 100``). The scores, the config and the host seconds of every step
(each ends in a fetch of the loss) go to ``<--dir>/distill_metrics.json``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import time

import numpy as np
import torch

from eo_diffusion_torch.cli.common import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Few-step distillation (PyTorch/CUDA)")
    p.add_argument("--preset", type=str, default="flow64",
                   help="the preset the teacher was trained with")
    p.add_argument("--ckpt", type=str, required=True,
                   help="the teacher's checkpoint (cli.train's logs/<run>/<name>)")
    p.add_argument("--method", type=str, default="reflow",
                   choices=["reflow", "consistency", "progressive", "guided"],
                   help="reflow = flow-teacher straightening; consistency = DDPM-teacher "
                        "consistency distillation; progressive = Salimans-Ho halving rounds "
                        "(DDPM teachers); guided = the CFG-combined teacher folded into a "
                        "single-call student (class-conditional flow or DDPM teachers)")
    p.add_argument("--guidance_scale", type=float, default=3.0,
                   help="guided: the CFG scale w baked into the student")
    p.add_argument("--pool_n", type=int, default=4096,
                   help="guided + ddpm: the teacher-sample x0 pool's size")
    p.add_argument("--pool_steps", type=int, default=50,
                   help="guided + ddpm: teacher DDIM steps for the pool")
    p.add_argument("--pd_base_steps", type=int, default=16,
                   help="progressive: round 1's teacher grid (halves each round)")
    p.add_argument("--pd_rounds", type=int, default=2, help="progressive: halving rounds")
    p.add_argument("--cd_points", type=int, default=18,
                   help="consistency: grid points over the teacher chain")
    p.add_argument("--huber_c", type=float, default=0.0,
                   help="consistency: pseudo-Huber c (0 = squared L2)")
    p.add_argument("--sigma_data", type=float, default=0.5,
                   help="consistency: data std of the boundary coefficients (pixels in "
                        "[-1, 1]: 0.5; latent presets: 1.0)")
    p.add_argument("--target_decay", type=float, default=0.95,
                   help="consistency: the slow-EMA target's decay")
    p.add_argument("--dir", type=str, default="results/distill",
                   help="output directory (metrics and the student checkpoint)")
    p.add_argument("--n_pairs", type=int, default=4096,
                   help="teacher couplings (reflow, guided flow) or pool samples "
                        "(consistency, progressive)")
    p.add_argument("--pair_steps", type=int, default=32,
                   help="teacher sampler steps a coupling or pool sample")
    p.add_argument("--pair_method", type=str, default="heun", choices=["euler", "heun"])
    p.add_argument("--steps", type=int, default=2000, help="student steps (a round)")
    p.add_argument("--batch_size", type=int, default=None, help="default: the preset's")
    p.add_argument("--lr", type=float, default=1e-4,
                   help="peak LR (fine-tuning: about 10x below training)")
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--few_steps", type=int, nargs="+", default=[1, 2, 4],
                   help="few-step counts scored before and after")
    p.add_argument("--eval_n", type=int, default=64,
                   help="held-out noise draws for the scores")
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_bf16", action="store_true")
    p.add_argument("--use_raw_params", action="store_true",
                   help="distill from the teacher's raw weights instead of its EMA")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; never falls back silently")
    return p.parse_args(argv)


def _fn(model):
    return lambda x, t, c, y: model(x, t, cond=c, y=y)


def _load_teacher(args, mcfg, device):
    """The teacher from a port checkpoint (EMA weights unless
    ``--use_raw_params``), on ``device``, in eval mode, frozen."""
    from eo_diffusion_torch.cli.presets import build_denoiser
    from eo_diffusion_torch.weights import load_reference_checkpoint

    model = build_denoiser(mcfg)
    try:
        model.load_state_dict(load_reference_checkpoint(args.ckpt, mcfg,
                                                        use_ema=not args.use_raw_params),
                              strict=True)
    except RuntimeError as e:
        hint = (" guidance distillation needs a teacher trained WITH CFG label dropout (the "
                "null class row): cli.train --preset cflow64 / cddpm64, or --class_dropout"
                if args.method == "guided" else "")
        raise SystemExit(f"failed to load the teacher from {args.ckpt}: {e}{hint}")
    print(f"teacher loaded from {args.ckpt} "
          f"({'raw' if args.use_raw_params else 'ema'} weights)")
    return model.to(device).eval().requires_grad_(False)


def _student(teacher):
    """A trainable copy of the teacher."""
    return copy.deepcopy(teacher).requires_grad_(True).train()


def _frozen(model):
    return copy.deepcopy(model).requires_grad_(False).eval()


@torch.no_grad()
def _ema_update(ema, model, decay: float) -> None:
    e, p = list(ema.parameters()), list(model.parameters())
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, p, alpha=1.0 - decay)


def _fit(args, model, loss_fn, after_step=None, label=""):
    """``args.steps`` AdamW steps of ``loss_fn(i)`` on ``model``'s
    parameters under the warmup-cosine table; ``after_step()`` runs after
    each update (the EMA, the consistency target). Returns ``(optimizer,
    losses, step_seconds)``, each step's seconds ending in a fetch of its
    loss."""
    from eo_diffusion_torch.train.lr_schedules import set_lr, warmup_cosine_decay

    table = warmup_cosine_decay(0.0, args.lr, max(args.steps // 20, 1), args.steps,
                                args.lr * 0.01)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=float(table[0]), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    losses, seconds = [], []
    every = max(args.steps // 10, 1)
    for i in range(args.steps):
        t0 = time.perf_counter()
        set_lr(opt, table, i)
        loss = loss_fn(i)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        if after_step is not None:
            after_step()
        losses.append(loss.detach().item())
        seconds.append(time.perf_counter() - t0)
        if (i + 1) % every == 0:
            print(f"{label}step {i + 1}/{args.steps} loss={losses[-1]:.5f} "
                  f"({sum(seconds) / len(seconds) * 1e3:.0f} ms/step)")
    return opt, losses, seconds


def _timing(seconds):
    steady = seconds[2:] if len(seconds) > 2 else seconds
    return {"step_seconds": seconds,
            "steps_per_s": len(steady) / sum(steady) if steady else None}


def _save(args, model, ema, optimizer, steps, results):
    """The student checkpoint (``model`` raw, ``ema`` served) in the train
    state's layout, and ``distill_metrics.json``."""
    from eo_diffusion_torch.train.checkpoint import save_checkpoint
    from eo_diffusion_torch.train.trainer import TrainState

    state = TrainState(model, ema, optimizer)
    state.step = state.opt_step = int(steps)
    os.makedirs(args.dir, exist_ok=True)
    path = save_checkpoint(os.path.abspath(args.dir), state.state_dict(), name="student")
    results["config"] = dict(vars(args))
    with open(os.path.join(args.dir, "distill_metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"student checkpoint: {path}")
    results["checkpoint"] = path
    return results


def _setup(args):
    from eo_diffusion_torch.cli.presets import build_process, get_preset

    device = resolve_device(args.device, "eo_diffusion_torch.cli.distill")
    preset = get_preset(args.preset)
    if args.image_size:
        preset.image_size = args.image_size
    batch_size = args.batch_size or preset.batch_size
    # the inner process on the model-facing grid (the latent grid of a latent
    # preset): the whole distillation runs there
    process = build_process(preset, preset.timesteps, preset.image_size, cond_type=None)
    if preset.is_latent:
        print(f"latent preset: distilling on the {process.image_size}x{process.image_size}x"
              f"{process.in_channels} latent grid")
    dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(args.seed)
    # held-out evaluation noise, drawn apart from every training draw
    egen = torch.Generator(device=device).manual_seed(args.seed + 10_007)
    shape = (args.eval_n, process.image_size, process.image_size, process.in_channels)
    eval_eps = torch.randn(shape, generator=egen, device=device)
    return device, preset, batch_size, process, dtype, gen, eval_eps


def main(args):
    """Run the method. Returns the results dict (the scores, the timing of the
    steps, the checkpoint's path), also written to ``distill_metrics.json``."""
    from eo_diffusion_torch.cli.presets import get_preset

    preset = get_preset(args.preset)
    if args.method == "guided":
        assert preset.num_classes > 0, (
            "guidance distillation folds CLASSIFIER-FREE guidance: the teacher preset must be "
            f"class-conditional ({preset.name!r} has num_classes=0; use cflow64/cddpm64)")
        assert preset.process in ("flow", "ddpm"), preset.process
        return _guided_main(args)
    if args.method in ("consistency", "progressive"):
        assert preset.process == "ddpm", (
            f"{args.method} distillation needs a DDPM-chain teacher; preset {preset.name!r} "
            f"trains {preset.process!r} (flow teachers use --method reflow)")
        return _progressive_main(args) if args.method == "progressive" else _consistency_main(
            args)
    assert preset.process == "flow", (
        f"ReFlow distills rectified flows; preset {preset.name!r} trains process "
        f"{preset.process!r} (use a flow preset, e.g. flow64, or --method consistency for "
        f"DDPM teachers)")
    return _reflow_main(args)


def _flow_scores(args, flow, fn, eval_eps, eval_x1, dtype, label, y=None):
    from eo_diffusion_torch.diffusion.distill import endpoint_gap, straightness

    out = {"straightness": float(straightness(flow, fn, eval_eps, eval_x1, y=y))}
    for k in args.few_steps:
        out[f"euler{k}_gap"] = float(endpoint_gap(flow, fn, eval_eps, few_steps=k, y=y,
                                                  dtype=dtype))
    print(f"[{label}] " + "  ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def _reflow_main(args):
    from eo_diffusion_torch.diffusion.distill import coupling_batches, generate_couplings

    device, preset, batch_size, flow, dtype, gen, eval_eps = _setup(args)
    mcfg = preset.model_config(bf16=not args.no_bf16)
    teacher = _load_teacher(args, mcfg, device)
    t0 = time.time()
    eps, x1 = generate_couplings(flow, _fn(teacher), args.n_pairs, device=device, generator=gen,
                                 num_steps=args.pair_steps, method=args.pair_method,
                                 batch_size=batch_size, dtype=dtype)
    pair_seconds = time.time() - t0
    print(f"{args.n_pairs} couplings via {args.pair_method}-{args.pair_steps} in "
          f"{pair_seconds:.1f}s")
    with torch.no_grad():
        eval_x1 = flow.sample(_fn(teacher), args.eval_n, device=device,
                              num_steps=args.pair_steps, method=args.pair_method, x_T=eval_eps,
                              dtype=dtype).x
    results = {"teacher": _flow_scores(args, flow, _fn(teacher), eval_eps, eval_x1, dtype,
                                       "teacher")}

    student, ema = _student(teacher), _frozen(teacher)
    it = coupling_batches(eps, x1, batch_size, seed=args.seed + 1)

    def loss_fn(i):
        b = next(it)
        return flow.train_loss(_fn(student), torch.as_tensor(b["image"], device=device),
                               generator=gen, noise=torch.as_tensor(b["noise"], device=device))

    opt, losses, seconds = _fit(args, student, loss_fn, lambda: _ema_update(
        ema, student, args.ema_decay))
    print(f"re-fit: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    results["student"] = _flow_scores(args, flow, _fn(ema), eval_eps, eval_x1, dtype,
                                      "student")
    for k in args.few_steps:
        assert np.isfinite(results["student"][f"euler{k}_gap"]), "nan gap"
    results["timing"] = {**_timing(seconds), "couplings_seconds": pair_seconds}
    results["losses"] = losses
    return _save(args, student, ema, opt, args.steps, results)


def _ddim_pool(process, fn, n, batch_size, steps, dtype, gen, device, chunk_kw=None):
    """``n`` teacher DDIM samples (float32 numpy), ``batch_size`` at a time;
    ``chunk_kw(i)`` gives chunk i's further sampler keywords."""
    with torch.no_grad():
        pool = [process.ddim_sample(fn, batch_size, device=device, generator=gen,
                                    num_steps=steps, dtype=dtype,
                                    **(chunk_kw(i) if chunk_kw else {})).x.float().cpu().numpy()
                for i in range(-(-n // batch_size))]
    return np.concatenate(pool)[:n]


def _gaps(args, sample_k, ref, label, prefix):
    """Relative RMS gap to the teacher's reference of each few-step count."""
    ref_norm = float(torch.sqrt((ref ** 2).mean()))
    out = {}
    with torch.no_grad():
        for k in args.few_steps:
            x = sample_k(k)
            out[f"{prefix}{k}_gap"] = float(torch.sqrt(((x - ref) ** 2).mean())) / ref_norm
    print(f"[{label}] " + "  ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def _consistency_main(args):
    """Consistency distillation of a DDPM-chain teacher, data-free (the x0
    pool is the teacher's own DDIM samples); the slow-EMA target is served."""
    from eo_diffusion_torch.diffusion.consistency import ConsistencyDistillation

    device, preset, batch_size, diffusion, dtype, gen, eval_eps = _setup(args)
    if preset.is_latent:
        print(f"consistency on latents with sigma_data={args.sigma_data}; scaled latents are "
              "about unit std: consider --sigma_data 1.0")
    mcfg = preset.model_config(bf16=not args.no_bf16)
    teacher = _load_teacher(args, mcfg, device)
    cd = ConsistencyDistillation.create(diffusion, n_points=args.cd_points,
                                        huber_c=args.huber_c, sigma_data=args.sigma_data)
    t0 = time.time()
    pool = _ddim_pool(diffusion, _fn(teacher), args.n_pairs, batch_size, args.pair_steps,
                      dtype, gen, device)
    pool_seconds = time.time() - t0
    print(f"{len(pool)} teacher DDIM-{args.pair_steps} samples as the x0 pool in "
          f"{pool_seconds:.1f}s")
    with torch.no_grad():
        ref = diffusion.ddim_sample(_fn(teacher), args.eval_n, device=device,
                                    num_steps=args.pair_steps, x_T=eval_eps, dtype=dtype).x

    def score(model, label):
        hop = lambda: torch.Generator(device=device).manual_seed(99)
        return _gaps(args, lambda k: cd.sample(_fn(model), args.eval_n, device=device,
                                               generator=hop(), steps=k, x_T=eval_eps,
                                               dtype=dtype).x, ref, label, "cm")

    results = {"teacher_init": score(teacher, "teacher-init")}
    student, target = _student(teacher), _frozen(teacher)
    data_rng = np.random.default_rng(args.seed + 1)

    def loss_fn(i):
        x0 = torch.as_tensor(pool[data_rng.integers(0, len(pool), batch_size)], device=device)
        return cd.distill_loss(_fn(student), _fn(target), _fn(teacher), x0, generator=gen)

    opt, losses, seconds = _fit(args, student, loss_fn, lambda: cd.update_target(
        target.parameters(), student.parameters(), args.target_decay))
    print(f"distilled: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    results["student"] = score(target, "student")  # the slow-EMA target is served
    results["timing"] = {**_timing(seconds), "pool_seconds": pool_seconds}
    results["losses"] = losses
    return _save(args, student, target, opt, args.steps, results)


def _progressive_main(args):
    """Progressive distillation: ``--pd_rounds`` halving rounds from a
    ``--pd_base_steps`` teacher grid, v students (round 1 re-reads the
    preset's head as v), on a pool of teacher DDIM samples."""
    from eo_diffusion_torch.diffusion.progressive import ProgressiveDistillation, pd_sample

    device, preset, batch_size, diffusion, dtype, gen, eval_eps = _setup(args)
    mcfg = preset.model_config(bf16=not args.no_bf16)
    teacher = _load_teacher(args, mcfg, device)
    t0 = time.time()
    pool = _ddim_pool(diffusion, _fn(teacher), args.n_pairs, batch_size, args.pair_steps,
                      dtype, gen, device)
    pool_seconds = time.time() - t0
    print(f"{len(pool)} teacher DDIM-{args.pair_steps} samples as the x0 pool in "
          f"{pool_seconds:.1f}s")
    with torch.no_grad():
        ref = diffusion.ddim_sample(_fn(teacher), args.eval_n, device=device,
                                    num_steps=args.pair_steps, x_T=eval_eps, dtype=dtype).x
    v_process = dataclasses.replace(diffusion, objective="v")

    def score(model, label, process):
        return _gaps(args, lambda k: pd_sample(process, _fn(model), args.eval_n, device=device,
                                               steps=k, x_T=eval_eps, dtype=dtype).x,
                     ref, label, "pd")

    results = {"teacher_init": score(teacher, "teacher-init", diffusion)}
    data_rng = np.random.default_rng(args.seed + 1)
    student, n_teacher, timing = teacher, args.pd_base_steps, {}
    for r in range(args.pd_rounds):
        n_student = n_teacher // 2
        assert n_student >= 1, (
            f"--pd_base_steps {args.pd_base_steps} halves below 1 step at round {r + 1}; "
            "fewer --pd_rounds or a larger base")
        # round 1 distills the preset's head into a v student; later rounds v -> v
        pd = ProgressiveDistillation.create(diffusion, n_student,
                                            teacher_objective=None if r == 0 else "v")
        teacher_r, student = _frozen(student), _student(student)

        def loss_fn(i, pd=pd, teacher_r=teacher_r, student=student):
            x0 = torch.as_tensor(pool[data_rng.integers(0, len(pool), batch_size)],
                                 device=device)
            return pd.distill_loss(_fn(student), _fn(teacher_r), x0, generator=gen)

        opt, losses, seconds = _fit(args, student, loss_fn,
                                    label=f"round {r + 1} ({n_teacher}->{n_student} steps) ")
        print(f"round {r + 1}: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
        results[f"round{r + 1}"] = score(student, f"round{r + 1} ({n_student}-step)",
                                         v_process)
        timing[f"round{r + 1}"] = {**_timing(seconds), "losses": losses}
        n_teacher = n_student
    results["timing"] = {**timing, "pool_seconds": pool_seconds}
    results["final_steps"] = n_teacher
    results["student_objective"] = "v"
    return _save(args, student, _frozen(student), opt, args.steps * args.pd_rounds, results)


def _guided_main(args):
    """Guidance distillation (Meng et al., arXiv:2210.03142): the CFG-combined
    class-conditional teacher folded into a single-call student. Flow
    teachers: couplings simulated from the guided ODE, the student re-fit on
    them (the CFG fold and ReFlow's straightening at once). DDPM teachers:
    the student regresses the guided eps at q-sampled points of a pool of
    guided teacher samples. The student keeps the fixed w."""
    from eo_diffusion_torch.diffusion.distill import cfg_model_fn, generate_couplings

    device, preset, batch_size, process, dtype, gen, eval_eps = _setup(args)
    n_classes, w = preset.num_classes, args.guidance_scale
    # the null row must exist: cfg_model_fn calls class num_classes
    mcfg = preset.model_config(bf16=not args.no_bf16,
                               class_dropout_prob=preset.class_dropout or 0.1)
    teacher = _load_teacher(args, mcfg, device)
    print(f"guided teacher w={w:g}, {n_classes} classes")
    guided = cfg_model_fn(_fn(teacher), w, n_classes)
    npr = np.random.default_rng(args.seed)
    results = {"guidance_scale": w, "process": preset.process}
    student, ema = _student(teacher), _frozen(teacher)

    if preset.process == "flow":
        y_pairs = npr.integers(0, n_classes, args.n_pairs).astype(np.int64)
        t0 = time.time()
        eps, x1 = generate_couplings(process, guided, args.n_pairs, device=device,
                                     generator=gen, num_steps=args.pair_steps,
                                     method=args.pair_method, batch_size=batch_size,
                                     dtype=dtype, y=y_pairs)
        print(f"{args.n_pairs} GUIDED couplings via {args.pair_method}-{args.pair_steps} in "
              f"{time.time() - t0:.1f}s")
        eval_y = torch.as_tensor(np.arange(args.eval_n) % n_classes, device=device)
        with torch.no_grad():
            eval_x1 = process.sample(guided, args.eval_n, device=device,
                                     num_steps=args.pair_steps, method=args.pair_method,
                                     x_T=eval_eps, y=eval_y, dtype=dtype).x
        results["teacher"] = _flow_scores(args, process, guided, eval_eps, eval_x1, dtype,
                                          "guided teacher", y=eval_y)
        # the couplings stay on the device; a step gathers its batch there
        x1_d, eps_d = (torch.as_tensor(a, device=device) for a in (x1, eps))
        y_d = torch.as_tensor(y_pairs, device=device)

        def loss_fn(i):
            idx = torch.randint(0, len(x1_d), (batch_size,), generator=gen, device=device)
            return process.train_loss(_fn(student), x1_d[idx], generator=gen, y=y_d[idx],
                                      noise=eps_d[idx])

        opt, losses, seconds = _fit(args, student, loss_fn, lambda: _ema_update(
            ema, student, args.ema_decay))
        print(f"re-fit: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
        results["student"] = _flow_scores(args, process, _fn(ema), eval_eps, eval_x1, dtype,
                                          "single-call student", y=eval_y)
    else:  # ddpm: the guided eps regressed on a pool of guided teacher samples
        y_pool = npr.integers(0, n_classes, args.pool_n).astype(np.int64)
        y_null = torch.full((batch_size,), n_classes, dtype=torch.long, device=device)
        t0 = time.time()
        chunk_kw = lambda i: dict(
            y=torch.as_tensor(np.resize(y_pool[i * batch_size:(i + 1) * batch_size],
                                        batch_size), device=device),
            guidance_scale=w, y_uncond=y_null, clip=True)
        pool = _ddim_pool(process, _fn(teacher), args.pool_n, batch_size, args.pool_steps,
                          dtype, gen, device, chunk_kw)
        print(f"{args.pool_n} guided teacher samples (DDIM-{args.pool_steps}, w={w:g}) in "
              f"{time.time() - t0:.1f}s")
        pool_d, y_d = torch.as_tensor(pool, device=device), torch.as_tensor(y_pool, device=device)

        def loss_fn(i):
            idx = torch.as_tensor(npr.integers(0, args.pool_n, batch_size), device=device)
            x0b, yb = pool_d[idx], y_d[idx]
            t = torch.randint(0, process.timesteps, (batch_size,), generator=gen, device=device)
            noise = torch.randn(x0b.shape, generator=gen, device=device)
            x_t = process.q_sample(x0b, t, noise).to(dtype)
            with torch.no_grad():
                target = guided(x_t, t, None, yb).float()
            return ((_fn(student)(x_t, t, None, yb).float() - target) ** 2).mean()

        opt, losses, seconds = _fit(args, student, loss_fn, lambda: _ema_update(
            ema, student, args.ema_decay))
        print(f"regression: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
        results["teacher"] = {"pool_steps": args.pool_steps}
        results["student"] = {"regression_loss_first": losses[0],
                              "regression_loss_final": losses[-1]}
    results["timing"] = _timing(seconds)
    results["losses"] = losses
    return _save(args, student, ema, opt, args.steps, results)


if __name__ == "__main__":
    main(parse_args())
