"""Attention with a transposed output on the GPU, beside what the port ships.

    python -m eo_diffusion_torch.tools.probe_packed_pv [--out results/packed_pv.json]

The port of the JAX package's probe (``tools/probe_packed_pv.py``) at its
shape, the 256 px headline's attention: qkv5 ``[8, 3, 8, 4096, 48]`` bf16.
On the TPU the transposed formulation (o ``[B, H, D, T]``, PV with D on the
row axis) removed the lane padding of D 48; on Hopper mma.sync takes n in
steps of 8 and there is no such padding, so the question becomes what the
transposed store costs. Measured on the card (CUDA events):

* the transposed-output kernel (``ops.attn_probes.transposed_attention_cuda``)
  and its error against the plain version;
* what the port ships for the same function: the separate-tensor attention
  kernel (``ops.attention.flash_attention_cuda``, K2's port) on the qkv5
  plane views, plus the transpose to ``[B, H, D, T]``;
* ``F.scaled_dot_product_attention`` on the same planes, timed only;
* the card's bound.

:func:`measure` holds the kernel against the plain version at any shape.

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
from eo_diffusion_torch.ops import attn_probes as AP
from eo_diffusion_torch.tools.timing import PEAK_BF16, PEAK_F32, bound_ms, card_line, cuda_ms

B, T, H, D = 8, 4096, 8, 48
REPS = 20


def attention_bound_ms(b: int, t: int, h: int, d: int, dtype: torch.dtype = torch.bfloat16):
    """The least time of one attention forward: 4 B H T^2 D operations at the
    dtype's peak (bf16 tensor cores, or f32), or qkv read and o written once;
    (ms, by)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
    return bound_ms(4.0 * b * h * t * t * d, peak, 4 * b * h * t * d * esize)


def attention_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """An attention probe's output against its plain version: the largest
    difference; the largest against max(rms, |plain|) elementwise, rms over
    the whole plain output (at unit-normal inputs thousands of keys share the
    weight, so |plain| sits far below 1 and a floor of 1 would make any limit
    an absolute one); and the relative L2 difference, which a fault that
    scales every output (l off by 1 %) moves by its own size."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rms = want.pow(2).mean().sqrt()
    return {"max_abs_err": diff.max().item(), "out_rms": rms.item(),
            "max_rms_scaled_err": (diff / want.abs().clamp(min=rms)).max().item(),
            "rel_l2_err": (diff.pow(2).mean().sqrt() / rms).item()}


def planted_faults(got: torch.Tensor, want: torch.Tensor, dropped: torch.Tensor) -> dict:
    """What :func:`attention_errors` reads for two faults a kernel could have:
    its output ``got`` 1 % off everywhere (as from l off by 1 %), and
    ``dropped``, the plain version with one K/V stage of keys left out."""
    return {"scaled_1pct": attention_errors((got.float() / 1.01).to(got.dtype), want),
            "stage_dropped": attention_errors(dropped, want)}


def shipped(qkv5: torch.Tensor) -> torch.Tensor:
    """The port's separate-tensor kernel on the plane views, then the
    transpose to [B, H, D, T]."""
    q, k, v = (qkv5[:, j].transpose(1, 2) for j in range(3))  # [B, T, H, D] views
    return A.flash_attention_cuda(q, k, v).permute(0, 2, 3, 1).contiguous()


def measure(qkv5: torch.Tensor, reps: int = REPS) -> dict:
    """The transposed-output kernel against its plain version on one CUDA
    ``qkv5``: its errors (:func:`attention_errors`), the kernel, plain and
    SDPA times and the bound; one row."""
    b, _, h, t, d = qkv5.shape
    row = {"shape": f"B{b} T{t} H{h} D{d}", "dtype": str(qkv5.dtype).split(".")[-1],
           **attention_errors(AP.transposed_attention_cuda(qkv5),
                              AP.transposed_attention_reference(qkv5))}
    q4, k4, v4 = (qkv5[:, j] for j in range(3))  # [B, H, T, D] views
    row["kernel_ms"] = cuda_ms(lambda: AP.transposed_attention_cuda(qkv5), reps)
    row["plain_ms"] = cuda_ms(lambda: AP.transposed_attention_reference(qkv5), 2, warmup=1)
    row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, scale=1.0 / math.sqrt(d)), reps)  # SDPA
    row["bound_ms"], row["bound_by"] = attention_bound_ms(b, t, h, d, qkv5.dtype)
    return row


def run(seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_packed_pv: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv5 = torch.randn(B, 3, H, T, D, generator=g, device="cuda").to(torch.bfloat16)
    res = {"card": card_line(), **measure(qkv5)}
    ref = AP.transposed_attention_reference(qkv5).float()
    res["max_abs_err_shipped_vs_plain"] = (shipped(qkv5).float() - ref).abs().max().item()
    del ref
    res["shipped_ms"] = cuda_ms(lambda: shipped(qkv5), REPS)
    res["shipped_kernel_only_ms"] = cuda_ms(
        lambda: A.flash_attention_cuda(*(qkv5[:, j].transpose(1, 2) for j in range(3))), REPS)
    res["speedup_vs_shipped"] = res["shipped_ms"] / res["kernel_ms"]
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
