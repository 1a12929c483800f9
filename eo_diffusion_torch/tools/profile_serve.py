"""What the serving engine adds to a sampler run: a device batch of
``cli.serve``'s engine beside the same sampler with the model called
directly, from the same seed's draws.

    python -m eo_diffusion_torch.tools.profile_serve [--preset sen12mscr256] [--batch_size 8] \
        [--sampler_steps 50] [--rounds 4] [--out results/profile_serve.json]

Builds the engine as ``cli.serve`` does (any of its flags pass through;
seeded random weights), then times, in alternation over ``--rounds``
rounds after one warm-up each, ``SamplerEngine.generate`` (the program:
the parameters through ``torch.func.functional_call``, the seed's draws as
its inputs) and the engine's sampler over the model's own ``forward``
under ``no_grad`` with the same draws. Each time is on the host's clock
and ends with the batch on the host. The two batches must be the same
bits. Prints one JSON line (the card's name and power limit on a GPU) and
writes it to ``--out`` as well.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from eo_diffusion_torch.cli import serve as serve_cli
from eo_diffusion_torch.serving import seeding
from eo_diffusion_torch.weights import randomize_parameters


def direct_batch(engine, seed: int, y=None, cond=None) -> np.ndarray:
    """``engine.generate(seed, y, cond)``'s batch with the model called
    directly on its own parameters (which must hold the engine's weights)."""
    model = engine.model

    def fn(x, t, c, yy):
        return model(x, t, cond=c, y=yy)

    gen = seeding.generator(seed, engine.device)
    x_T = seeding.normal(gen, engine.grid)
    y_t, c_t = engine._inputs(y, cond)
    with torch.no_grad():
        out = engine._sample(fn, x_T, lambda j: seeding.normal(gen, engine.grid), y_t, c_t)
    return out.cpu().numpy()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--seed", type=int, default=62, help="the weights' seed")
    p.add_argument("--out", default=None)
    args, rest = p.parse_known_args(argv)
    sargs = serve_cli.parse_args(rest if "--preset" in rest else
                                 ["--preset", "sen12mscr256", *rest])
    engine, batcher, meta = serve_cli.build_engine(sargs)
    batcher.shutdown()
    assert not (engine.cfg.int8 or engine.cfg.pag_scale), (
        "the direct call runs the model's own float weights without PAG")
    randomize_parameters(engine.model, args.seed)
    engine.swap_params(dict(engine.model.named_parameters()))
    y, cond = engine._blank_y(), engine._blank_cond()
    runs = {"engine": lambda: engine.generate(1, y, cond),
            "direct": lambda: direct_batch(engine, 1, y, cond)}
    outs = {k: f() for k, f in runs.items()}  # warm-up
    assert np.array_equal(outs["engine"], outs["direct"]), "the two batches differ"
    secs = {k: [] for k in runs}
    for _ in range(args.rounds):
        for k, f in runs.items():
            t0 = time.perf_counter()
            f()
            secs[k].append(time.perf_counter() - t0)
    res = {"preset": sargs.preset, "batch_size": engine.batch_size,
           "sampler": engine.cfg.sampler, "steps": engine.cfg.steps,
           "device": engine.device.type, "seconds": secs,
           "median_s": {k: statistics.median(v) for k, v in secs.items()}}
    res["engine_over_direct"] = res["median_s"]["engine"] / res["median_s"]["direct"]
    if engine.device.type == "cuda":
        from eo_diffusion_torch.tools.timing import card_line

        res["card"] = card_line()
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
