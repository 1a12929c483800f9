"""Do more query rows a block, sharing each K/V load, pay on the GPU?

    python -m eo_diffusion_torch.tools.profile_attn_variants2 [--out results/attn_variants2.json]

The port of the JAX package's second experiment
(``tools/profile_attn_variants2.py``, ``kern_chunked``: online-softmax
attention over KV chunks, q tiles of 512-4096 rows) at its shape: q, k, v
``[8, 4096, 8, 48]`` bf16, unit normal. ``kern_chunked`` computes variant B
(``ops.attn_variants``), K1's recipe, so the sweep runs B's kernel at every
tile it takes: 4, 8 and 16 warps of 32 query rows a block (K1's 128 rows, 2x
and 4x as many sharing each K/V tile) by 64 and 128 keys a K/V stage. The
TPU's q tiles of 512-4096 rows do not exist here: a block's registers hold
512 query rows at most, and 16 warps already cap a thread at 128 registers.

Measured on the card (CUDA events), with :func:`profile_attn_variants.measure`:
each tile's time and error against the plain version, SDPA on the same
planes, the mma.sync body the variants copy (``flash_attention_mma_cuda``)
and the bound.
Prints one JSON line with the card's name and power limit; writes it to
``--out`` only when given. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os

from eo_diffusion_torch.tools import profile_attn_variants

#: (warps of 32 query rows a block, keys a K/V stage)
SWEEP = tuple((w, bk) for w in (4, 8, 16) for bk in (64, 128))


def measure(q, k, v, tiles=SWEEP, reps: int = profile_attn_variants.REPS) -> dict:
    """Variant B at each tile against its plain version on CUDA tensors
    ``[B, T, H, D]`` bf16 (:func:`profile_attn_variants.measure`)."""
    return profile_attn_variants.measure(q, k, v, ("B",), tiles, reps)


def run(seed: int = 0) -> dict:
    return profile_attn_variants.run(seed, ("B",), SWEEP)


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
