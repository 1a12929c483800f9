"""Where p should live between the two attention products, on the GPU.

    python -m eo_diffusion_torch.tools.probe_softmax_orient [--extra] [--out results/softmax_orient.json]

The port of the JAX package's probe (``tools/probe_softmax_orient.py``) at its
shape: the 256 px headline's ds-4 attention, B8 T4096 H8 D48, cut into the
TPU kernel's q tiles of 512 and key chunks of 2048 (BH 64 cells). On the TPU
the question was which axis the softmax should reduce along (lanes or
sublanes) and what an in-kernel transpose of p costs; on Hopper it becomes
whether a reduction along rows or along columns streams at the card's memory
rate, what a transpose through shared memory costs, and whether PV computed
transposed (the output's ``[D, T]`` orientation in the accumulator) beats an
epilogue transpose. Measured on the card (CUDA events):

* the softmax statistics (``ops.softmax_probes.softmax_stats``) of s ``[64,
  512, 2048]`` f32 along its rows, and of ``sᵀ`` ``[64, 2048, 512]`` along its
  columns (the same numbers); beside them ``torch.logsumexp`` along the same
  axis, the nearest single PyTorch call (not the same function);
* the transpose (``ops.softmax_probes.transpose_accumulate``) of p ``[64, 512,
  2048]`` bf16; beside it ``p.mT.to(float32)``, the same bytes without the
  factor NK (not the same function);
* the hybrid attentions (``ops.attn_probes.hybrid_attention``, p through
  shared memory and in registers) at qkv5 ``[8, 3, 8, 4096, 48]`` bf16, beside
  the transposed-output kernel (``transposed_attention_cuda``: PV the usual
  way round, the output transposed in the epilogue), and SDPA on the plane
  views (its ``[B, H, T, D]`` output, and with the transpose);
* with ``--extra``, the hybrids at 128 and 256 keys a K/V stage (the JAX
  tool's bk sweep: 1024 and 4096 there; a block's shared memory bounds the
  stage here);
* each kernel's error against its plain version and the card's bound.

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

from eo_diffusion_torch.ops import attn_probes as AP
from eo_diffusion_torch.ops import softmax_probes as SP
from eo_diffusion_torch.tools.probe_packed_pv import attention_bound_ms, attention_errors
from eo_diffusion_torch.tools.timing import PEAK_F32, bound_ms, card_line, cuda_ms

B, T, H, D = 8, 4096, 8, 48
BQ, BK = 512, 2048  # the TPU kernel's q tile and key chunk: one cell is s [BQ, BK]
REPS = 20
# f32 operations an element of the statistics: max, subtract, exp, add
STATS_OPS = 4


def stats_bound_ms(bh: int, m: int, n: int, axis: int):
    """s read once, one f32 a row (axis 1) or column (axis 0) written, or the
    f32 operations; (ms, by)."""
    return bound_ms(STATS_OPS * bh * m * n, PEAK_F32, 4 * bh * m * n + 4 * bh * (m if axis else n))


def transpose_bound_ms(bh: int, m: int, n: int):
    """p read once in bf16 and written once in f32, or the NK - 1 adds; (ms, by)."""
    return bound_ms((SP.NK - 1) * bh * m * n, PEAK_F32, (2 + 4) * bh * m * n)


def _errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got.float() - want.float()).abs()
    return {"max_abs_err": diff.max().item(),
            "max_rel_err": diff.max().item() / max(want.float().abs().max().item(), 1e-30)}


def _row(shape, x, **kw) -> dict:
    return {"shape": "x".join(map(str, shape)), "dtype": str(x.dtype).split(".")[-1], **kw}


def measure(s: torch.Tensor, p: torch.Tensor, qkv5: torch.Tensor, reps: int = REPS,
            block_ks=(AP.HYBRID_KEYS,)) -> dict:
    """Every kernel of the probe against its plain version on CUDA inputs:
    the statistics of ``s`` ``[BH, M, N]`` f32 along its rows and of ``sᵀ``
    along its columns, the transpose of ``p`` ``[BH, M, N]`` bf16, and both
    hybrid attentions of ``qkv5`` ``[B, 3, H, T, D]`` bf16 at each of
    ``block_ks``; errors, kernel, plain, yardstick and bound times, one row
    each."""
    rows, outs = {}, {}
    for name, x, axis in (("stats_rows", s, 1), ("stats_cols", s.mT.contiguous(), 0)):
        want = SP.softmax_stats_reference(x, axis)
        outs[name] = SP.softmax_stats_cuda(x, axis).flatten(1)
        row = _row(x.shape, x, axis=axis, **_errors(outs[name], want.flatten(1)))
        row["kernel_ms"] = cuda_ms(lambda: SP.softmax_stats_cuda(x, axis), reps)
        row["plain_ms"] = cuda_ms(lambda: SP.softmax_stats_reference(x, axis), 3, warmup=1)
        row["library_ms"] = None  # no PyTorch call computes max + sum(exp(s - max))
        row["nearest_call"] = "torch.logsumexp along the same axis (not the same function)"
        row["nearest_call_ms"] = cuda_ms(lambda: torch.logsumexp(x, dim=axis + 1, keepdim=True),
                                         reps)
        row["bound_ms"], row["bound_by"] = stats_bound_ms(*x.shape, axis)
        rows[name] = row
    # the two orientations reduce the same numbers: they differ by the order of sums
    rows["stats_rows"]["max_abs_diff_to_cols"] = (
        (outs["stats_rows"] - outs["stats_cols"]).abs().max().item())
    del x, want, outs

    got, want = SP.transpose_accumulate_cuda(p), SP.transpose_accumulate_reference(p)
    row = _row(p.shape, p, bit_exact=bool(torch.equal(got, want)), **_errors(got, want))
    del got, want
    row["kernel_ms"] = cuda_ms(lambda: SP.transpose_accumulate_cuda(p), reps)
    row["plain_ms"] = cuda_ms(lambda: SP.transpose_accumulate_reference(p), 3, warmup=1)
    row["library_ms"] = None  # no single call sums NK transposes
    row["nearest_call"] = "p.mT.to(float32) contiguous (the same bytes, without the factor NK)"
    row["nearest_call_ms"] = cuda_ms(lambda: p.mT.to(torch.float32,
                                                     memory_format=torch.contiguous_format), reps)
    row["bound_ms"], row["bound_by"] = transpose_bound_ms(*p.shape)
    rows["transpose"] = row

    b, _, h, t, d = qkv5.shape
    ref = AP.transposed_attention_reference(qkv5)
    plain_ms = cuda_ms(lambda: AP.transposed_attention_reference(qkv5), 2, warmup=1)
    q4, k4, v4 = (qkv5[:, j] for j in range(3))  # [B, H, T, D] views
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0 / math.sqrt(d))
    library_ms = cuda_ms(sdpa, reps)
    library_t_ms = cuda_ms(lambda: sdpa().mT.contiguous(), reps)
    shipped_ms = cuda_ms(lambda: AP.transposed_attention_cuda(qkv5), reps)
    bound, by = attention_bound_ms(b, t, h, d, qkv5.dtype)
    for bk in block_ks:
        for variant in AP.HYBRIDS:
            row = _row((b, h, t, d), qkv5, block_k=bk,
                       **attention_errors(AP.hybrid_attention_cuda(qkv5, variant, bk), ref))
            row["kernel_ms"] = cuda_ms(lambda: AP.hybrid_attention_cuda(qkv5, variant, bk), reps)
            row.update(plain_ms=plain_ms, library_ms=library_ms,
                       library_call="F.scaled_dot_product_attention on the plane views "
                                    "([B, H, T, D] out)",
                       library_plus_transpose_ms=library_t_ms,
                       transposed_epilogue_ms=shipped_ms, bound_ms=bound, bound_by=by)
            rows[variant if bk == AP.HYBRID_KEYS else f"{variant}_bk{bk}"] = row
    return rows


def run(seed: int = 0, extra: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_softmax_orient: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = torch.randn(B * H, BQ, BK, generator=g, device="cuda")
    p = torch.randn(B * H, BQ, BK, generator=g, device="cuda").to(torch.bfloat16)
    qkv5 = torch.randn(B, 3, H, T, D, generator=g, device="cuda").to(torch.bfloat16)
    bks = (AP.HYBRID_KEYS, 2 * AP.HYBRID_KEYS, 4 * AP.HYBRID_KEYS) if extra else (AP.HYBRID_KEYS,)
    res = {"card": card_line(), **measure(s, p, qkv5, block_ks=bks)}
    for variant in AP.HYBRIDS:
        res[variant]["speedup_vs_transposed_epilogue"] = (
            res[variant]["transposed_epilogue_ms"] / res[variant]["kernel_ms"])
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--extra", action="store_true",
                    help="also the hybrids at 128 and 256 keys a K/V stage")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    res = run(args.seed, args.extra)
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
