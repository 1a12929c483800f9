"""What each piece of the wgmma/TMA attention backward costs, on the GPU.

    python -m eo_diffusion_torch.tools.profile_attn_bwd_sm90 [--variants a,b] [--out results/bwd_sm90.json]

Builds copies of ``csrc/attention_bwd_sm90.cu`` with one or two pieces
changed and times each against the body as built (CUDA events, alternating
order, median of four rounds) at the clouds UNet's ds-4 training shapes,
B8 T4096 H8 D48 (256 px) and B4 T16384 H8 D48 (512 px), through the port's
separate-tensor entry on the ``split_qkv`` views:

* ``delta``: the delta kernel alone (both passes skipped);
* ``q_pass`` / ``kv_pass``: delta and one pass, the other skipped;
* ``q_pass_no_exp``, ``kv_pass_no_exp``: that pass with ex2 replaced by a
  move (wrong on purpose);
* ``q_pass_no_products``, ``kv_pass_no_products``: that pass issuing no
  products for tiles after the first (wrong on purpose): what the loads,
  the scaling, the elementwise step and the synchronisation take alone;
* ``no_elementwise``: both passes without P and dS for tiles after the
  first (wrong on purpose);
* ``no_turns``: the two consumer warpgroups issue without taking turns
  through the named barriers;
* ``two_stages``, ``three_stages``: a ring of at most 2 or 3 stages instead
  of 4 (as many as fit in shared memory);
* ``no_loads``: TMA loads only the first ring's worth of streamed tiles,
  later tiles reuse what the stages hold (wrong on purpose): what the
  streamed loads from L2 cost;
* ``no_scale``: the streamed k or q tiles are not scaled by s (wrong on
  purpose);
* ``no_lse_loads``: the KV pass's producer warps do not read the streamed
  queries' lse and delta (wrong on purpose);
* ``q_smem``, ``kv_smem``: that pass's owned rows in shared memory (SS
  products) instead of register fragments (RS) at D 48;
* ``q_smem_keys_128``: the Q pass's owned rows in shared memory and 128
  keys a stage instead of 64.

Each row gives the variant's time, the body's, their ratio and the
variant's error against the plain version over dq, dk and dv
(``probe_packed_pv.attention_errors``; the skipped, wrong and partial
variants are off by design). Prints one JSON line with the card's name and
power limit; writes it to ``--out`` only when given. Needs a CUDA device
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

import torch

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.tools.probe_packed_pv import attention_errors
from eo_diffusion_torch.tools.profile_attn_fwd_sm90 import build_variants
from eo_diffusion_torch.tools.timing import card_line, cuda_ms

KERNEL = "attention_bwd_sm90"
_Q_BLOCKS = "pass_body<DP, AW, kQ>(maps.m[0], p, smem_raw);"
_KV_BLOCKS = "pass_body<DP, AW, kKV>(maps.m[1], p, smem_raw);"
#: one change: (text of the source, its replacement); the pass a variant
#: skips still launches its blocks, which return at once
CHANGES = {
    "no_q_pass": (_Q_BLOCKS, "return;"),
    "no_kv_pass": (_KV_BLOCKS, "return;"),
    "no_exp": ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x;"),
    "no_products": ("issue_xy(s);\n      wgmma_commit();\n      issue_out(sp);", ""),
    "no_elementwise": ("      elementwise(j, s);\n", ""),
    "no_turns": ("named_sync(my_turn, 256);", ""),
    "two_stages": ("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 2;"),
    "three_stages": ("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 3;"),
    "q_keys_128": ("constexpr int kQKeys = 64;", "constexpr int kQKeys = 128;"),
    "no_lse_loads": ("          l2 = lse[j * BN + i] * kLog2e;\n          dl = delta[j * BN + i];",
                     "          l2 = 0.f;"),
    "q_smem": ("constexpr int kRegAQ = 64;", "constexpr int kRegAQ = 0;"),
    "kv_smem": ("constexpr int kRegAKV = 64;", "constexpr int kRegAKV = 0;"),
    "no_loads": ("          mbar_arrive_expect_tx(&bar.full[s], Tl::STAGE_BYTES);",
                 "          if (j >= S) {\n            mbar_arrive(&bar.full[s]);\n"
                 "            continue;\n          }\n"
                 "          mbar_arrive_expect_tx(&bar.full[s], Tl::STAGE_BYTES);"),
    "no_scale": ("scale_tile(stage_b1(s), Tl::TILE_BYTES / 16, i, kScalers, s2);", ""),
}
#: variant -> the changes it makes
VARIANTS = {
    "delta": ("no_q_pass", "no_kv_pass"), "q_pass": ("no_kv_pass",),
    "kv_pass": ("no_q_pass",),
    "q_pass_no_exp": ("no_kv_pass", "no_exp"), "kv_pass_no_exp": ("no_q_pass", "no_exp"),
    "q_pass_no_products": ("no_kv_pass", "no_products"),
    "kv_pass_no_products": ("no_q_pass", "no_products"),
    "no_elementwise": ("no_elementwise",), "no_turns": ("no_turns",),
    "two_stages": ("two_stages",), "three_stages": ("three_stages",),
    "no_loads": ("no_loads",), "no_scale": ("no_scale",),
    "no_lse_loads": ("no_lse_loads",), "q_smem": ("q_smem",),
    "kv_smem": ("kv_smem",), "q_smem_keys_128": ("q_smem", "q_keys_128"),
}
#: (B, T, H, D): the clouds UNet's ds-4 attention in training at 256 px,
#: batch 8, and at 512 px, batch 4
SHAPES = ((8, 4096, 8, 48), (4, 16384, 8, 48))


def variant_source(name: str) -> str:
    """The body's source with the variant's changes."""
    src = (_build._CSRC / f"{KERNEL}.cu").read_text()
    for change in VARIANTS[name]:
        old, new = CHANGES[change]
        if old not in src:
            raise RuntimeError(f"variant {name}: {change}'s text is not in the source any more")
        src = src.replace(old, new)
        if change == "no_turns":  # and no arrivals on the barriers nobody waits at
            src = src.replace("named_arrive(other_turn, 256);", "(void)0;")
    return src


def run(seed: int = 0, variants=tuple(VARIANTS), shapes=SHAPES, rounds: int = 4) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn_bwd_sm90: needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"body": _build.load(KERNEL),
                **build_variants({n: variant_source(n) for n in variants}, Path(tmp))}

        def use(name):  # route the wrapper's bf16 launches to one library
            _build._loaded[KERNEL] = libs[name]

        g = torch.Generator(device="cuda").manual_seed(seed)
        res = {"card": card_line(), "rows": []}
        flat = lambda xs: torch.cat([x.flatten() for x in xs])
        try:
            for b, t, h, d in shapes:
                qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(torch.bfloat16)
                q, k, v = A.split_qkv(qkv, h)
                out, lse = A.flash_attention_cuda(q, k, v, return_lse=True)
                dout = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
                ref = (flat(A.reference_attention_bwd(q, k, v, out, lse, dout))
                       if t <= 4096 else None)
                bwd = lambda: A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
                reps = 3 if t > 4096 else 10
                times = {n: [] for n in libs}
                errs = {}
                for n in libs:
                    use(n)
                    got = bwd()
                    if ref is not None:
                        errs[n] = attention_errors(flat(got), ref)["rel_l2_err"]
                for i in range(rounds):
                    for n in (list(libs) if i % 2 == 0 else list(libs)[::-1]):
                        use(n)
                        times[n].append(cuda_ms(bwd, reps))
                med = {n: sorted(x)[len(x) // 2] for n, x in times.items()}
                for n in variants:
                    res["rows"].append({"shape": f"B{b} T{t} H{h} D{d}", "variant": n,
                                        "ms": med[n], "body_ms": med["body"],
                                        "vs_body": med[n] / med["body"],
                                        "rel_l2_err": errs.get(n),
                                        "body_rel_l2_err": errs.get("body")})
                del qkv, q, k, v, out, lse, dout, ref
                torch.cuda.empty_cache()
        finally:
            use("body")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to time (default: all)")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    res = run(args.seed, variants=tuple(args.variants.split(",")))
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
