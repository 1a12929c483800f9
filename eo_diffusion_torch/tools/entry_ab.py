"""End-to-end rates of two checkouts in alternating order, on the GPU.

    git archive <commit> | tar -x -C .parent   # a directory .gitignore lists
    python -m eo_diffusion_torch.tools.entry_ab .parent . [--rounds 1] [--out ab.json]

Runs the entry-point phases of each checkout's own ``chip_smoke.py``, in a
process of its own with that checkout first on ``sys.path``, in the order
A B B A (``--rounds`` such rounds), so two versions are compared on one card
within one call:

* phase 5, the sampling entry point at 256 px: ``sen12mscr256`` DDIM-50,
  batch 8 (``run_cli``), img/s of the second batch;
* phase 7 and 7b, the training entry point at 256 px, batch 8, and at
  512 px, batch 4 (``run_train``, ``run_train_512``, here 20 and 12
  steps): steps/s after the first two steps, the steps alone as
  ``chip_smoke.py`` prints them, and start to start (``Trainer.step``'s
  calls, so the feed's share counts too); ``best`` checkpoint saves are
  skipped, so no 1 GB write falls between two steps;
* phase 6 and 5d's ``dit64``, the host-bound 64 px sampling paths
  (``clouds64-attn`` RePaint DDPM-100, one batch of 8; ``dit64`` DDIM-50,
  img/s over the second and third batch of 8).

Prints one JSON line with every run, the card's name and power limit;
writes it to ``--out`` only when given. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# run in the checkout's own process: its chip_smoke.py and its package
_PHASES = r"""
import json, tempfile, time
import chip_smoke as C
from eo_diffusion_torch.cli.presets import get_preset
from eo_diffusion_torch.train import checkpoint as CK, trainer as TR

C.TRAIN_STEPS, C.TRAIN_STEPS_512 = 20, 12
_save, _step, starts = CK.save_checkpoint, TR.Trainer.step, []

def save(d, s, step=None, name=None):
    return None if name == "best" else _save(d, s, step=step, name=name)

def step(self, state, batch):
    starts.append(time.perf_counter())
    return _step(self, state, batch)

CK.save_checkpoint, TR.Trainer.step = save, step
res = {"card": C.card_line()}
with tempfile.TemporaryDirectory() as tmp:
    r = C.run_cli(["--preset", "sen12mscr256", "--dataset", "synthetic", "--sampler", "ddim",
                   "--sampler_steps", "50", "--batch_size", "8", "--n_iter", "1",
                   "--device", "cuda"], get_preset("sen12mscr256").unet_config(cond_channels=3),
                  2, tmp)
    res["sample_256px_b8_img_per_s"] = 8 / r["batch_seconds"][1]
    for name, fn, seed in (("train_256px_b8", C.run_train, 4),
                           ("train_512px_b4", C.run_train_512, 5)):
        starts.clear()
        steady = fn(tmp, seed=seed)["step_seconds"][2:]
        res[name + "_steps_per_s"] = len(steady) / sum(steady)
        periods = [b - a for a, b in zip(starts[2:], starts[3:])]
        res[name + "_wall_steps_per_s"] = len(periods) / sum(periods)
    r = C.run_cli(["--preset", "clouds64-attn", "--dataset", "synthetic", "--sampler", "ddpm",
                   "--timesteps", "100", "--batch_size", "8", "--n_iter", "1",
                   "--device", "cuda"], get_preset("clouds64-attn").unet_config(), 3, tmp)
    res["clouds64_img_per_s"] = r["images"] / r["sample_seconds"]
    r = C.run_cli(["--preset", "dit64", "--dataset", "synthetic", "--sampler", "ddim",
                   "--sampler_steps", "50", "--batch_size", "8", "--n_iter", "2",
                   "--device", "cuda"], get_preset("dit64").model_config(), 8, tmp)
    steady = r["batch_seconds"][1:]
    res["dit64_img_per_s"] = 8 * len(steady) / sum(steady)
print("ENTRY_AB " + json.dumps(res), flush=True)
"""


def run_checkout(path: str, timeout: float = 900.0) -> dict:
    """The phases of the checkout at ``path`` in a process of its own."""
    path = os.path.abspath(path)
    env = {**os.environ, "PYTHONPATH": path}
    proc = subprocess.run([sys.executable, "-c", _PHASES], cwd=path, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("ENTRY_AB ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"entry_ab: {path} exited {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("ENTRY_AB "):])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", help="the first checkout (e.g. the parent commit, unpacked)")
    ap.add_argument("b", help="the second checkout")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of A B B A")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    runs = []
    for _ in range(args.rounds):
        for tag, path in (("a", args.a), ("b", args.b), ("b", args.b), ("a", args.a)):
            runs.append({"checkout": tag, "path": path, **run_checkout(path)})
            print(json.dumps(runs[-1]), flush=True)
    res = {"a": args.a, "b": args.b, "card": runs[0]["card"], "runs": runs}
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
