"""Time the one-launch GroupNorm kernels at every team count, on the GPU.

    python -m eo_diffusion_torch.tools.profile_group_norm [--teams 1,2,4,8] [--out f.json]

For each of the clouds UNet's level shapes at batch 8 (256 px levels 0-3,
the level-0 256-channel concat site, 512 px level 0; bf16, SiLU but level
2's attention norm), times the forward and backward of
``csrc/group_norm_sm90.cu`` on the device alone (``timing.queued_ms``)
with the plan ``ops.group_norm.plan`` picks and with the team count fixed
to each of ``--teams``, beside the old three-launch body
(``group_norm.cu``) on the same tensors. Every launch is held against the
plain version first. It shows what a round of a team (its barrier and
combine) costs against the bytes it saves, which is what the planner's cost
model weighs. Prints one JSON line a shape and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import torch

from eo_diffusion_torch.ops import group_norm as G
from eo_diffusion_torch.tools.timing import card_line, queued_ms

SHAPES = ((8, 65536, 128, "silu"), (8, 16384, 256, "silu"), (8, 4096, 384, "none"),
          (8, 1024, 512, "silu"), (8, 65536, 256, "silu"), (8, 262144, 128, "silu"))
GROUPS = 32


def _scaled(got, want, floor):
    return ((got.float() - want.float()).abs() / want.float().abs().clamp(min=floor)).max().item()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--teams", default="1,2,4,8")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_group_norm: needs a CUDA device")
    card = card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for n, hw, c, act in SHAPES:
        x = torch.randn(n, hw, c, generator=g, device="cuda").bfloat16()
        dy = torch.randn(n, hw, c, generator=g, device="cuda").bfloat16()
        gamma = 1 + 0.1 * torch.randn(n, c, generator=g, device="cuda")
        beta = 0.1 * torch.randn(n, c, generator=g, device="cuda")
        ref = G.group_norm_reference(x, gamma, beta, GROUPS, act=act)
        _, mean, rstd = G.group_norm_fwd_legacy_cuda(x, gamma, beta, GROUPS, act=act)
        rdx = G.group_norm_backward_reference(x, gamma, beta, mean, rstd, dy, GROUPS, act)[0]
        rms = rdx.float().pow(2).mean().sqrt().item()
        fwd = lambda: G.group_norm_fwd_cuda(x, gamma, beta, GROUPS, act=act)
        bwd = lambda: G.group_norm_bwd_cuda(x, gamma, beta, mean, rstd, dy, GROUPS, act)
        row = {"shape": [n, hw, c, GROUPS, act], "card": card,
               "old_ms": [queued_ms(lambda: G.group_norm_fwd_legacy_cuda(
                   x, gamma, beta, GROUPS, act=act), args.reps),
                   queued_ms(lambda: G.group_norm_bwd_legacy_cuda(
                       x, gamma, beta, mean, rstd, dy, GROUPS, act), args.reps)],
               "bound_ms": [2 * x.numel() * 2 / 3.35e9, 3 * x.numel() * 2 / 3.35e9]}
        for teams in [None] + [int(t) for t in args.teams.split(",") if int(t) <= n]:
            plans = {}
            for d in ("fwd", "bwd"):
                key = (d, n, hw, c, GROUPS, x.dtype, x.device.index)
                G._plans.pop(key, None)
                chosen = G._card_plan(d, x, n, hw, c, GROUPS)
                if teams is not None:
                    p = G.plan(d, n, hw, c, GROUPS, 2, sms, lambda t, s: 1, teams=teams)
                    G._plans[key] = (p, (ctypes.c_int * 12)(*p.ints()))
                plans[d] = G._plans[key][0]
            errs = [_scaled(fwd()[0], ref, 1.0), _scaled(bwd()[0], rdx, rms)]
            assert max(errs) <= 1e-2, (row["shape"], teams, errs)
            row["chosen" if teams is None else f"teams_{teams}"] = {
                d: {"mode": p.mode, "teams": p.teams, "blocks": p.blocks,
                    "chunk_rows": p.chunk_rows, "held_rows": p.held_rows} for d, p in plans.items()
            } | {"ms": [queued_ms(fwd, args.reps), queued_ms(bwd, args.reps)],
                 "max_scaled_err": errs}
            G._plans.pop(("fwd", n, hw, c, GROUPS, x.dtype, x.device.index), None)
            G._plans.pop(("bwd", n, hw, c, GROUPS, x.dtype, x.device.index), None)
        print(json.dumps(row), flush=True)
        out.append(row)
        del x, dy, ref, rdx
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in out)
    return out


if __name__ == "__main__":
    main()
