"""The attention core's two products alone on the GPU, in the probe's seven forms.

    python -m eo_diffusion_torch.tools.probe_attn_matmuls [--out results/attn_matmuls.json]

The port of the JAX package's probe (``tools/probe_attn_matmuls.py``) at its
shapes: the 256 px headline's attention (T 4096, D 48) cut into q tiles of
512 and key chunks of 2048. One probe call does the work of one attention
forward's products: for each of BH 64 cells, NQ 8 q tiles, each NK 2 times
one product (the probe's ``_bench``: grid (BH, NQ), NK products a cell).
Here a call is NQ launches of the probe kernel, each BH cells x NK products.

The seven forms (``main()``): QKᵀ as shipped, with D pre-padded to 128, with
a transposed output; PV as shipped, with v pre-padded to 128, transposed, and
the two-head pack of 96 lanes. Per form: the kernel's time for one call and
its rate over the probe's flop count, its error against the plain version
(one launch), the card's bound for the call, and ``torch.bmm`` (bf16, for
reference; timed only). Prints one JSON line with the card's name and power
limit; writes it to ``--out`` only when given. Needs a CUDA device.

What it can and cannot answer on this card: a launch does 12.9 GFLOP (0.013
ms at the bf16 peak), but the QKᵀ forms write an f32 ``[64, 512, 2048]``
output, 268 MB (0.080 ms), and the PV forms read a bf16 p of ``[64, 512,
2048]``, 134 MB (0.040 ms): every form is bound by the bytes of its
materialised score-sized operand, which the attention kernels never write,
so it cannot split K1's time between QKᵀ and PV. The lane padding the probe
was written to price (D 48 padded to 128 on the TPU's 128-wide unit) does not
exist on Hopper, where mma.sync takes n in steps of 8.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from eo_diffusion_torch.ops import attn_probes as AP
from eo_diffusion_torch.tools.timing import PEAK_BF16, bound_ms, card_line, cuda_ms

BH, NQ, NK = 64, 8, AP.NK
BQ, BK, D = 512, 2048, 48
REPS = 20  # timed probe calls a form
# name -> (layout, a's cell shape, b's cell shape, useful flops of one product)
VARIANTS = {
    "QK^T  q[512,48] . k[2048,48]^T": ("nt", (BQ, D), (BK, D), 2 * BQ * BK * D),
    "QK^T  D pre-padded to 128": ("nt", (BQ, 128), (BK, 128), 2 * BQ * BK * 128),
    "QK^T  transposed out [2048,512]": ("nt", (BK, D), (BQ, D), 2 * BQ * BK * D),
    "PV    p[512,2048] . v[2048,48]": ("nn", (BQ, BK), (BK, D), 2 * BQ * BK * D),
    "PV    v pre-padded to 128": ("nn", (BQ, BK), (BK, 128), 2 * BQ * BK * 128),
    "PV    transposed [48,512] out": ("tn", (BK, D), (BK, BQ), 2 * BQ * BK * D),
    "PV    v[2048,96] (2-head lane pack)": ("nn", (BQ, BK), (BK, 96), 2 * BQ * BK * 96),
}


def out_cell(layout: str, a_shape, b_shape):
    """(M, N) of one cell's output."""
    m = a_shape[1] if layout == "tn" else a_shape[0]
    n = b_shape[0] if layout == "nt" else b_shape[1]
    return m, n


def launch_bound(layout: str, a_shape, b_shape, flops: float):
    """One launch's least time: its NK products over every cell at the bf16
    peak, or a and b read once and the f32 output written once; (ms, by)."""
    m, n = out_cell(layout, a_shape, b_shape)
    nbytes = BH * (2 * (a_shape[0] * a_shape[1] + b_shape[0] * b_shape[1]) + 4 * m * n)
    return bound_ms(BH * NK * flops, PEAK_BF16, nbytes)


def library_call(layout: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` of the same operands in bf16 (bf16 output, one product):
    the library's yardstick, timed only."""
    if layout == "nt":
        return torch.bmm(a, b.transpose(1, 2))
    if layout == "nn":
        return torch.bmm(a, b)
    return torch.bmm(a.transpose(1, 2), b)


def run_variant(name: str, gen: torch.Generator) -> dict:
    layout, a_shape, b_shape, flops = VARIANTS[name]
    a = torch.randn(BH, *a_shape, generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn(BH, *b_shape, generator=gen, device="cuda").to(torch.bfloat16)
    got = AP.matmul_probe_cuda(a, b, layout)
    want = AP.matmul_probe_reference(a, b, layout)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    plain_ms = cuda_ms(lambda: AP.matmul_probe_reference(a, b, layout), 2, warmup=1)
    del got, want

    def call():  # one probe call: NQ launches
        for _ in range(NQ):
            AP.matmul_probe_cuda(a, b, layout)

    ms = cuda_ms(call, REPS)
    bound, by = launch_bound(layout, a_shape, b_shape, flops)
    return {"name": name, "layout": layout, "a": list(a_shape), "b": list(b_shape),
            "max_abs_err": err, "max_rel_err": rel, "call_ms": ms,
            "tflops": flops * BH * NQ * NK / ms / 1e9, "launch_ms": ms / NQ,
            "bound_ms": bound * NQ, "launch_bound_ms": bound, "bound_by": by,
            "plain_launch_ms": plain_ms,
            "library_bmm_ms": cuda_ms(lambda: library_call(layout, a, b), REPS * NQ)}


def run(seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_attn_matmuls: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"card": card_line(),
            "shapes": {"BH": BH, "NQ": NQ, "NK": NK, "BQ": BQ, "BK": BK, "D": D,
                       "dtype": "bfloat16"},
            "variants": [run_variant(name, gen) for name in VARIANTS]}


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
