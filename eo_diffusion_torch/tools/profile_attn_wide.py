"""The wide-head attention kernels (``csrc/attention_wide.cu``) on the GPU:
held against the plain version, timed, and taken apart.

    python -m eo_diffusion_torch.tools.profile_attn_wide [--variants a,b] [--out f.json]

1. ``checks``: forward (with the lse) and backward against
   ``reference_attention`` / ``reference_attention_bwd`` (the backward from
   the kernel forward's o and lse, as autograd hands them over) at head dims
   264 to 4096, T from 64 to 4096 (ragged ones too), bf16 and float32, and
   whether two backward calls give the same bits.
2. ``times``: at inria64's and eurosat64's middle attention (one head of D
   1024 / 512) at T 64, 1024 and 4096, the kernel, the first wide pair
   (``attention_wide_resident.cu``, T up to 1024), SDPA and the bound, back
   to back (``cuda_ms``) and the device's time alone (``queued_ms``).
3. ``variants``: copies of the source with one piece changed, each timed
   against the source as built, in alternating order (``queued_ms``):

   * ``no_exchange``: the CTAs of a cluster do not sum their partial score
     tiles (wrong on purpose): what the exchange and its two cluster
     barriers cost;
   * ``no_pv``: no output product (wrong on purpose);
   * ``no_scores``: no score product (wrong on purpose);
   * ``one_term_p``: the forward's p rounded once to bf16 for PV, as K1's
     bf16 body does, in place of two bf16 terms;
   * ``ring3_split``, ``ring4_split``: a 3- or 4-deep ring of score chunks
     in a cluster (one CTA an SM) instead of 2;
   * ``split4``: clusters of at most 4 CTAs (dq and dk at D 1024 then
     recompute the score products over all of D).

Prints one JSON line with the card's name and power limit; writes it to
``--out`` only when given. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.tools.timing import (PEAK_BF16, PEAK_BYTES_PER_S, alternate_ms,
                                             card_line, cuda_ms, queued_ms)

KERNEL = "attention_wide"
#: variant -> [(text of the source, its replacement)]
VARIANTS = {
    "no_exchange": [("    if (kSplit) {\n      // X (and X2) = the sum",
                     "    if (false) {\n      // X (and X2) = the sum")],
    "no_pv": [("    for (int kk = 0; kk < kTile / 16; ++kk) {\n      uint32_t af[4], lo[4];",
               "    for (int kk = 0; kk < 0; ++kk) {\n      uint32_t af[4], lo[4];")],
    "no_scores": [("    score_chunk(x1, st, st + kTile * kLd, warp, lane);", "")],
    "one_term_p": [("        if (Job == kFwd) {\n          eo_tile::mma_bf16(o[2 * n2], lo,",
                    "        if (false) {\n          eo_tile::mma_bf16(o[2 * n2], lo,")],
    "ring3_split": [("kStages = two_products(Job) || kSplit ? 2 : 3;",
                     "kStages = two_products(Job) ? 2 : 3;")],
    "ring4_split": [("kStages = two_products(Job) || kSplit ? 2 : 3;",
                     "kStages = two_products(Job) ? 2 : (kSplit ? 4 : 3);")],
    "split4": [("constexpr int kMaxSplit = 8;", "constexpr int kMaxSplit = 4;")],
}
# (B, T, H, D, dtype, scale of the inputs): held against plain
CHECKS = [(8, 64, 1, 1024, torch.bfloat16, 2.0), (2, 77, 2, 264, torch.bfloat16, 2.0),
          (2, 1040, 1, 264, torch.bfloat16, 1.0), (1, 4096, 1, 1024, torch.bfloat16, 1.0),
          (2, 1040, 1, 512, torch.bfloat16, 1.0), (1, 130, 1, 2048, torch.bfloat16, 1.0),
          (1, 70, 1, 4096, torch.bfloat16, 1.0), (2, 130, 2, 136, torch.float32, 2.0),
          (1, 1040, 1, 136, torch.float32, 1.0), (1, 1024, 1, 520, torch.float32, 2.0)]
BWD_CHECKS = [(16, 64, 1, 1024, torch.bfloat16, 1.0), (2, 77, 2, 264, torch.bfloat16, 2.0),
              (1, 1040, 1, 264, torch.bfloat16, 1.0), (1, 4096, 1, 512, torch.bfloat16, 1.0),
              (1, 130, 1, 2048, torch.bfloat16, 1.0), (2, 130, 2, 136, torch.float32, 2.0),
              (1, 1040, 1, 136, torch.float32, 1.0)]
# (B, T, D): timed forward and backward shapes (one head, bf16)
FWD_TIMES = [(8, 64, 1024), (8, 1024, 1024), (8, 4096, 1024), (4, 4096, 512)]
BWD_TIMES = [(16, 64, 1024), (4, 1024, 1024), (4, 4096, 1024)]


def _errors(got, want):
    """max |got - want| / max(rms, |want|) and the relative L2 difference."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean().sqrt().item()
    return (((got - want).abs() / want.abs().clamp(min=rms)).max().item(),
            ((got - want).norm() / want.norm()).item())


def _planes(gen, b, t, h, d, dtype, f=1.0):
    return [(f * torch.randn(b, t, h, d, generator=gen, device="cuda")).to(dtype)
            for _ in range(3)]


def _plain_bwd(q, k, v, out, lse, dout):
    """The plain backward a sample at a time (its [T, T] tensors)."""
    b, t, h, _ = q.shape
    grads = [torch.empty_like(q) for _ in range(3)]
    lse4 = lse.reshape(b, h, t)
    for i in range(b):
        part = A.reference_attention_bwd(q[i:i + 1], k[i:i + 1], v[i:i + 1], out[i:i + 1],
                                         lse4[i], dout[i:i + 1])
        for g, x in zip(grads, part):
            g[i:i + 1] = x
    return grads


def checks(gen):
    rows = []
    for b, t, h, d, dtype, f in CHECKS:
        q, k, v = _planes(gen, b, t, h, d, dtype, f)
        out, lse = A.wide_attention_cuda(q, k, v, return_lse=True)
        refs = [A.reference_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], return_lse=True)
                for i in range(b)]
        ref, ref_lse = torch.cat([r[0] for r in refs]), torch.cat([r[1] for r in refs])
        err, l2 = _errors(out, ref)
        rows.append({"what": "fwd", "shape": f"B{b} T{t} H{h} D{d}", "dtype": str(dtype)[6:],
                     "max_rms_scaled_err": err, "rel_l2_err": l2,
                     "lse_max_abs_err": (lse - ref_lse).abs().max().item()})
    for b, t, h, d, dtype, f in BWD_CHECKS:
        q, k, v = _planes(gen, b, t, h, d, dtype, f)
        out, lse = A.wide_attention_cuda(q, k, v, return_lse=True)
        dout = torch.randn(b, t, h, d, generator=gen, device="cuda").to(dtype)
        first = A.wide_attention_bwd_cuda(q, k, v, out, lse, dout)
        second = A.wide_attention_bwd_cuda(q, k, v, out, lse, dout)
        flat = lambda xs: torch.cat([x.flatten() for x in xs])
        err, l2 = _errors(flat(first), flat(_plain_bwd(q, k, v, out, lse, dout)))
        rows.append({"what": "bwd", "shape": f"B{b} T{t} H{h} D{d}", "dtype": str(dtype)[6:],
                     "max_rms_scaled_err": err, "rel_l2_err": l2,
                     "same_bits": all(torch.equal(a, c) for a, c in zip(first, second))})
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


def _bound_ms(ops, nbytes):
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES_PER_S) * 1e3


def times(gen):
    rows = []
    for b, t, d in FWD_TIMES:
        q, k, v = _planes(gen, b, t, 1, d, torch.bfloat16)
        q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
        fns = {"kernel": lambda: A.wide_attention_cuda(q, k, v),
               "library": lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                 scale=1 / math.sqrt(d))}
        if t <= A._RESIDENT_MAX_T:
            fns["old_body"] = lambda: A.wide_attention_resident_cuda(q, k, v)
        reps = 10 if t >= 4096 else 50
        rows.append({"what": "fwd", "shape": f"B{b} T{t} H1 D{d}",
                     "ms": {n: cuda_ms(f, reps) for n, f in fns.items()},
                     "device_ms": {n: queued_ms(f, reps) for n, f in fns.items()},
                     "bound_ms": _bound_ms(4.0 * b * t * t * d, 8.0 * b * t * d)})
    for b, t, d in BWD_TIMES:
        q, k, v = _planes(gen, b, t, 1, d, torch.bfloat16)
        out, lse = A.wide_attention_cuda(q, k, v, return_lse=True)
        dout = torch.randn_like(out)
        q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous().requires_grad_() for x in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1 / math.sqrt(d))
        g4 = dout.permute(0, 2, 1, 3).contiguous()
        fns = {"kernel": lambda: A.wide_attention_bwd_cuda(q, k, v, out, lse, dout),
               "library": lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True)}
        if t <= A._RESIDENT_MAX_T:
            fns["old_body"] = lambda: A.wide_attention_bwd_resident_cuda(q, k, v, out, lse, dout)
        reps = 3 if t >= 4096 else 30
        rows.append({"what": "bwd", "shape": f"B{b} T{t} H1 D{d}",
                     "ms": {n: cuda_ms(f, reps) for n, f in fns.items()},
                     "device_ms": {n: queued_ms(f, reps) for n, f in fns.items()},
                     "bound_ms": _bound_ms(10.0 * b * t * t * d, 16.0 * b * t * d + 4 * b * t)})
        del q4, k4, v4, o4, g4
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


def _build_variants(names, tmp):
    """{name: the C entries of a copy of the source with one piece changed}."""
    src = Path(A.__file__).parent / "csrc" / _build.KERNELS[KERNEL]
    procs = {}
    for name in ["body", *names]:
        text = src.read_text()
        for old, new in VARIANTS.get(name, []):
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"lib{name}.so"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-o", str(so),
               str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc exit {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(so))
        for entry in ("eo_attention_wide_fwd", "eo_attention_wide_bwd"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = A._ARGTYPES[entry], ctypes.c_int
        libs[name] = lib
    return libs


def variants(gen, names):
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_variants(names, tmp)
        stream = lambda: torch.cuda.current_stream().cuda_stream

        def fwd(lib, q, k, v, out):
            b, t, h, d = q.shape
            assert lib.eo_attention_wide_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), A._strides(q, k, v), out.data_ptr(),
                None, 0, b, t, h, d, A._scale_in(d, q.dtype), 0, stream()) == 0

        def bwd(lib, q, k, v, o, lse, do, grads, delta):
            b, t, h, d = q.shape
            assert lib.eo_attention_wide_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), A._strides(q, k, v), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), *(g.data_ptr() for g in grads),
                delta.data_ptr(), 0, b, t, h, d, A._scale_in(d, q.dtype), A._scale(d), 0,
                stream()) == 0

        for b, t, d in FWD_TIMES:
            q, k, v = _planes(gen, b, t, 1, d, torch.bfloat16)
            out = torch.empty_like(q)
            fns = {n: (lambda lib=lib: fwd(lib, q, k, v, out)) for n, lib in libs.items()}
            rows.append(alternate_ms("fwd", f"B{b} T{t} H1 D{d}", fns, 10 if t >= 4096 else 50))
        for b, t, d in BWD_TIMES:
            q, k, v = _planes(gen, b, t, 1, d, torch.bfloat16)
            o, lse = A.wide_attention_cuda(q, k, v, return_lse=True)
            do = torch.randn_like(o)
            grads = [torch.empty_like(q) for _ in range(3)]
            delta = torch.empty(b, t, device="cuda")
            fns = {n: (lambda lib=lib: bwd(lib, q, k, v, o, lse, do, grads, delta))
                   for n, lib in libs.items() if n != "one_term_p"}
            rows.append(alternate_ms("bwd", f"B{b} T{t} H1 D{d}", fns, 3 if t >= 4096 else 30))
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to time (empty: none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn_wide needs a CUDA device")
    names = [n for n in args.variants.split(",") if n]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {sorted(VARIANTS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    res = {"card": card_line(), "checks": checks(gen), "times": times(gen),
           "variants": variants(gen, names) if names else []}
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return res


if __name__ == "__main__":
    main()
