"""What exp, the row max and deferred normalisation cost inside K1's loop, on the GPU.

    python -m eo_diffusion_torch.tools.profile_attn_variants [--out results/attn_variants.json]

The port of the JAX package's experiment (``tools/profile_attn_variants.py``)
at its shape, the 256 px headline's ds-4 attention: q, k, v ``[8, 4096, 8,
48]`` bf16, unit normal. Each variant is K1's loop with one piece changed
(``ops.attn_variants.attention_variant``):

* A: the statistics first (a sweep of K), then PV on ``round(p / l)`` (a
  second sweep of K and V): the TPU's shipped form, 1.5 times the products;
* B: PV on ``round(p)``, then ``/ l``: K1's recipe;
* C: PV on ``round(s)``, no max and no exp (wrong on purpose);
* D: B without the max (wrong for large scores).

Each runs at K1's tile (4 warps of 32 query rows, 64 keys a K/V stage) and at
twice the rows a block (the JAX tool's ``B defer-normalize bq1024``; its q
tiles of 512 and 1024 rows do not fit a block here). Measured on the card
(CUDA events): each variant's time, its error against its plain version,
the plain version's time, SDPA on the same planes where it computes the same
function (A and B; none for C and D), K1's body through the port's
separate-tensor entry on the same tensors (``flash_attention_cuda``, what
the port ships for B's function) and the card's bound.

:func:`measure` holds the kernel against the plain version at any shape and
tile. Prints one JSON line with the card's name and power limit; writes it
to ``--out`` only when given. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch
import torch.nn.functional as F

from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.ops import attn_variants as AV
from eo_diffusion_torch.tools.probe_packed_pv import (attention_bound_ms, attention_errors,
                                                      planted_faults)
from eo_diffusion_torch.tools.timing import card_line, cuda_ms

B, T, H, D = 8, 4096, 8, 48
REPS = 20
#: (warps of 32 query rows a block, keys a K/V stage): K1's, and twice its rows
TILES = (AV.K1_TILE, (8, 64))
#: products of each variant against the function's (A sweeps K twice)
PRODUCTS = {"A": 1.5, "B": 1.0, "C": 1.0, "D": 1.0}
#: keys of the K/V stage that the planted fault leaves out
STAGE = 64


def without_a_stage(x: torch.Tensor) -> torch.Tensor:
    """Keys or values ``[B, T, H, D]`` with the middle stage of :data:`STAGE`
    keys left out: the plain version on them is what a kernel that skipped
    one stage would compute."""
    t0 = STAGE * (x.shape[1] // 2 // STAGE)
    return torch.cat([x[:, :t0], x[:, t0 + STAGE:]], dim=1)


def measure(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variants=tuple(AV.VARIANTS),
            tiles=TILES, reps: int = REPS) -> dict:
    """Each variant at each tile against its plain version on CUDA tensors
    ``[B, T, H, D]`` bf16: errors (``probe_packed_pv.attention_errors``; at
    the first tile also what they read for two planted faults), kernel,
    plain, SDPA and shipped times and the bound; ``{"rows": [...],
    "shipped_ms", ...}``."""
    b, t, h, d = q.shape
    bound, by = attention_bound_ms(b, t, h, d, q.dtype)
    q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, T, D] views
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                scale=1.0 / math.sqrt(d)), reps)
    res = {"shape": f"B{b} T{t} H{h} D{d}", "dtype": str(q.dtype).split(".")[-1],
           "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
           "library_call": "F.scaled_dot_product_attention on the [B, H, T, D] views",
           "shipped_ms": cuda_ms(lambda: A.flash_attention_cuda(q, k, v), reps), "rows": []}
    for variant in variants:
        ref = AV.attention_variant_reference(q, k, v, variant)
        plain_ms = cuda_ms(lambda: AV.attention_variant_reference(q, k, v, variant), 2, warmup=1)
        for i, (warps, bk) in enumerate(tiles):
            got = AV.attention_variant_cuda(q, k, v, variant, warps, bk)
            row = {"variant": variant, "warps": warps, "query_rows": 32 * warps, "block_k": bk,
                   **attention_errors(got, ref), "products": PRODUCTS[variant]}
            if i == 0:
                row["planted_faults"] = planted_faults(got, ref, AV.attention_variant_reference(
                    q, without_a_stage(k), without_a_stage(v), variant))
            del got
            row["kernel_ms"] = cuda_ms(
                lambda: AV.attention_variant_cuda(q, k, v, variant, warps, bk), reps)
            row.update(plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=library_ms if variant in ("A", "B") else None)
            res["rows"].append(row)
        del ref
    return res


def run(seed: int = 0, variants=tuple(AV.VARIANTS), tiles=TILES) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("attention variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    res = {"card": card_line(), **measure(q, k, v, variants, tiles)}
    base = [r["kernel_ms"] for r in res["rows"]
            if r["variant"] == "B" and (r["warps"], r["block_k"]) == AV.K1_TILE]
    for row in res["rows"]:
        row["vs_b_at_k1_tile"] = row["kernel_ms"] / base[0] if base else None
        row["vs_shipped"] = row["kernel_ms"] / res["shipped_ms"]
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    res = run(args.seed)
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
