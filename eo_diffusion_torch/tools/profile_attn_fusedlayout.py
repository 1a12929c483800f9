"""Attention read straight from the fused ``[B, T, 3, H, D]`` tensor, on the GPU.

    python -m eo_diffusion_torch.tools.profile_attn_fusedlayout [--out results/attn_fusedlayout.json]

The port of the JAX package's prototype (``tools/profile_attn_fusedlayout.py``,
``kern`` via ``fused_layout_attn``) at its shape: qkv ``[8, 4096, 3, 8, 48]``
bf16, unit normal, o ``[8, 4096, 8, 48]``. The fused layout is the
projection ``[B, T, 3C]`` in the new head order, so the port's kernel for it
is K1 (``ops.attn_variants.fused_layout_attention``, the fused-projection
entry with ``new_order=True``). Measured on the card (CUDA events), beside
it:

* K1's body through the separate-tensor entry (K2's port) on the three
  ``[B, T, H, D]`` plane views of qkv (no copy);
* the JAX tool's "shipped (slice+fold)": the planes copied out first, then
  the same entry;
* SDPA on the ``[B, H, T, D]`` views;
* the route's error against its plain version, the plain version's time and
  the card's bound.

:func:`measure` holds the route against the plain version at any shape.
Prints one JSON line with the card's name and power limit; writes it to
``--out`` only when given. Needs a CUDA device.
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
from eo_diffusion_torch.tools.profile_attn_variants import without_a_stage
from eo_diffusion_torch.tools.timing import card_line, cuda_ms

B, T, H, D = 8, 4096, 8, 48
REPS = 20


def measure(qkv: torch.Tensor, reps: int = REPS) -> dict:
    """The fused-layout route against its plain version on a CUDA tensor
    ``[B, T, 3, H, D]``: errors (``probe_packed_pv.attention_errors``) and
    what they read for two planted faults, the route's, the separate-tensor
    entry's (views and slice+fold), the plain version's and SDPA's times and
    the bound; one row."""
    b, t, _, h, d = qkv.shape
    planes = [qkv[:, :, j] for j in range(3)]  # [B, T, H, D] views
    ref, got = AV.fused_layout_attention_reference(qkv), AV.fused_layout_attention(qkv)
    row = {"shape": f"B{b} T{t} H{h} D{d}", "dtype": str(qkv.dtype).split(".")[-1],
           **attention_errors(got, ref),
           "planted_faults": planted_faults(got, ref, A.reference_attention(
               planes[0], *(without_a_stage(x) for x in planes[1:])))}
    del ref, got
    row["kernel_ms"] = cuda_ms(lambda: AV.fused_layout_attention(qkv), reps)
    row["plain_ms"] = cuda_ms(lambda: AV.fused_layout_attention_reference(qkv), 2, warmup=1)
    row["separate_entry_views_ms"] = cuda_ms(lambda: A.flash_attention_cuda(*planes), reps)
    row["slice_fold_ms"] = cuda_ms(
        lambda: A.flash_attention_cuda(*(x.contiguous() for x in planes)), reps)
    q4, k4, v4 = (x.transpose(1, 2) for x in planes)  # [B, H, T, D] views
    row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, scale=1.0 / math.sqrt(d)), reps)
    row["bound_ms"], row["bound_by"] = attention_bound_ms(b, t, h, d, qkv.dtype)
    return row


def run(seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn_fusedlayout: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, T, 3, H, D, generator=g, device="cuda").to(torch.bfloat16)
    res = {"card": card_line(), **measure(qkv)}
    res["speedup_vs_slice_fold"] = res["slice_fold_ms"] / res["kernel_ms"]
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
