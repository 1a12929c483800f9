"""The float32 attention kernels (``csrc/attention_f32_sm90.cu``: every
product three TF32 products on the tensor cores) on the GPU: held against the
plain version, timed beside the FMA kernels they replaced and beside SDPA in
float32, and SDPA's float32 backend named.

    python -m eo_diffusion_torch.tools.profile_attn_f32 [--quick] [--runs N]
        [--variants a,b] [--out f.json]

1. ``checks``: forward (with the lse) and backward through both entries
   (the fused projection in either head order, three strided or contiguous
   tensors), head dims 8 to 128, ragged T, at unit-normal inputs against
   ``reference_attention`` / ``reference_attention_bwd`` by the largest
   difference against max(rms, |plain|) and the relative L2 difference;
   whether two backward calls give the same bits; and the same for the
   single-term variant (one TF32 product, the planted fault) at D 48 and 64.
2. ``times``: the shapes of the port's float32 paths (the ``synthetic64``
   classifier, ``--no_bf16`` at 256 px, a ragged separate-tensor case): the
   kernel, the FMA kernel it replaced, the plain version and SDPA with TF32
   off, back to back (``cuda_ms``) and the device's time alone
   (``queued_ms``), beside the bound: max(operations / 165 TFLOP/s, a third
   of the dense TF32 peak: the least time for float32-accurate products on
   the tensor cores; bytes / 3.35 TB/s).
3. ``sdpa``: the kernels SDPA launches in float32 with TF32 off, by name
   (``torch.profiler``), whether their SASS runs tensor-core TF32 products
   (HMMA) or FFMA, and its backward's device time at the classifier's
   shapes over ``--runs`` runs.
4. ``variants``: copies of the source with one piece changed, each timed
   against the source as built at --no_bf16's ds-4 shape (B8 T4096 H8 D48,
   forward and backward) and the classifier's (B8 T256 H4 D48), in
   alternating order (``queued_ms``); the single-term entry (plain TF32)
   beside them as ``one_term``:

   * ``no_scores``: no score product (wrong on purpose): its share;
   * ``no_values``: no value product (wrong on purpose; in the backward the
     scores then feed nothing and the compiler drops them too);
   * ``bn32``: 32 streamed rows a tile in the forward up to D 64 too (its
     64 halved: more CTAs an SM, twice the waits);
   * ``fwd_bounds_default``: the forward's ``__launch_bounds__(128)``
     without its two blocks an SM (ptxas then picks the register cap);
   * ``bwd_two_ctas``: the backward's launch bounds at two CTAs an SM.

   Each variant's ptxas registers and spills are printed beside it.
   * ``split_kv``: the backward's dK and dV in jobs of their own at D 48 and
     64 too (as above D 64: one more score product, half the accumulators).

Prints one JSON line with the card's name and power limit; writes it to
``--out`` only when given. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.tools.timing import (PEAK_TF32X3, alternate_ms, bound_ms, card_line,
                                             cuda_ms, queued_ms)
# (B, T, H, D, layout): held against plain; "legacy" / "new" the fused entry
# in that head order, "views" / "contiguous" the separate-tensor entry
CHECKS = [(8, 256, 4, 48, "legacy"), (8, 64, 4, 64, "legacy"), (2, 130, 2, 64, "new"),
          (2, 77, 3, 8, "views"), (1, 200, 2, 40, "contiguous"), (2, 130, 2, 128, "new"),
          (1, 129, 2, 96, "views"), (2, 1024, 8, 64, "legacy"), (2, 2309, 4, 48, "views"),
          (1, 1, 2, 48, "contiguous"), (1, 4096, 8, 48, "legacy")]
ONE_TERM = [(8, 256, 4, 48), (8, 64, 4, 64), (1, 4096, 8, 48)]
#: variant -> [(text of the source, its replacement)]
_SCORES = "    score_tile<DP, NT, TERMS>(s, {}, LO, p.scale_in, {}, LS, p.scale_in, g, t);"
VARIANTS = {
    "no_scores": [(_SCORES.format("xq", "sk"), ""),
                  (_SCORES.format("x1", "y1") + "\n    if constexpr (DQK) score_tile",
                   "    if constexpr (false) score_tile")],
    "no_values": [("    value_tile<DP, NT, TERMS>(o, s, sv, LS, 1.f, g, t);", ""),
                  ("    if constexpr (DV) value_tile", "    if constexpr (false) value_tile"),
                  ("    if constexpr (DQK) value_tile", "    if constexpr (false) value_tile")],
    "split_kv": [("constexpr bool kSplitKV = DP > 64;", "constexpr bool kSplitKV = DP > 32;")],
    "bn32": [(": (DP > 64 ? 32 : 64);", ": 32;")],
    "fwd_bounds_default": [("__launch_bounds__(kThreads, 2) attn_fwd_tf32",
                            "__launch_bounds__(kThreads) attn_fwd_tf32")],
    "bwd_two_ctas": [("__launch_bounds__(kThreads) attn_bwd_tf32",
                      "__launch_bounds__(kThreads, 2) attn_bwd_tf32")],
}
# (B, T, H, D): the variants' shapes
VARIANT_SHAPES = [(8, 4096, 8, 48), (8, 256, 4, 48)]
# (B, T, H, D, layout, what): the paths' shapes
TIMES = [(8, 256, 4, 48, "legacy", "synthetic64 classifier, ds 4"),
         (8, 64, 4, 64, "legacy", "synthetic64 classifier, ds 8"),
         (2, 1024, 8, 64, "legacy", "no preset (the FMA kernels' first timed shape)"),
         (2, 2309, 4, 48, "views", "ragged, separate-tensor entry"),
         (8, 4096, 8, 48, "legacy", "--no_bf16 256 px, ds 4"),
         (8, 1024, 8, 64, "legacy", "--no_bf16 256 px, ds 8")]


def errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """max |got - want| / max(rms, |want|) (rms over all of want) and the
    relative L2 difference."""
    got, want = got.double(), want.double()
    rms = want.pow(2).mean().sqrt()
    diff = (got - want).abs()
    return {"max_rms_scaled_err": (diff / want.abs().clamp(min=rms)).max().item(),
            "rel_l2_err": (diff.norm() / want.norm()).item()}


def inputs(gen, b, t, h, d, layout, f=1.0):
    """q, k, v [B, T, H, D] float32 (times ``f``) and the fused projection
    (None for the separate-tensor layouts)."""
    if layout in ("legacy", "new"):
        qkv = f * torch.randn(b, t, 3 * h * d, generator=gen, device="cuda")
        return (*A.split_qkv(qkv, h, layout == "new"), qkv)
    if layout == "views":  # a wider tensor's views: strided rows
        full = f * torch.randn(b, t, h, 3 * d + 8, generator=gen, device="cuda")
        return full[..., :d], full[..., d:2 * d], full[..., 2 * d + 8:], None
    return (*(f * torch.randn(b, t, h, d, generator=gen, device="cuda") for _ in range(3)), None)


def forward(q, k, v, qkv, layout, lse=True):
    """The float32 forward through the entry the layout names."""
    if qkv is not None:
        b, t, h, d = q.shape
        out, l = A.qkv_attention_f32_cuda(qkv, h, layout == "new", return_lse=True)
        return out.reshape(b, t, h, d), l
    return A.flash_attention_f32_cuda(q, k, v, return_lse=lse)


def backward(q, k, v, qkv, layout, out, lse, dout):
    if qkv is not None:
        b, t, h, d = q.shape
        dqkv = A.qkv_attention_bwd_f32_cuda(qkv, out.reshape(b, t, h * d), lse,
                                            dout.reshape(b, t, h * d), h, layout == "new")
        return A.split_qkv(dqkv, h, layout == "new")
    return A.flash_attention_bwd_f32_cuda(q, k, v, out, lse, dout)


def plain_bwd(q, k, v, out, lse, dout):
    """The plain backward a sample at a time (its [H, T, T] tensors)."""
    b, t, h, _ = q.shape
    grads = [torch.empty(q.shape, device=q.device) for _ in range(3)]
    lse4 = lse.reshape(b, h, t)
    for i in range(b):
        part = A.reference_attention_bwd(q[i:i + 1], k[i:i + 1], v[i:i + 1], out[i:i + 1],
                                         lse4[i], dout[i:i + 1])
        for g, x in zip(grads, part):
            g[i:i + 1] = x
    return grads


def flat(xs):
    return torch.cat([x.reshape(-1) for x in xs])


def check_row(gen, b, t, h, d, layout):
    """One shape at unit-normal inputs: forward, lse and backward errors
    against plain; the backward's bits on a repeat."""
    q, k, v, qkv = inputs(gen, b, t, h, d, layout)
    out, lse = forward(q, k, v, qkv, layout)
    ref, ref_lse = A.reference_attention(q, k, v, return_lse=True)
    dout = torch.randn(b, t, h, d, generator=gen, device="cuda")
    first = backward(q, k, v, qkv, layout, out, lse, dout)
    second = backward(q, k, v, qkv, layout, out, lse, dout)
    want = plain_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    return {"shape": f"B{b} T{t} H{h} D{d}", "layout": layout, "fwd": errors(out, ref),
            "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
            "bwd": errors(flat(first), flat(want)),
            "same_bits": all(torch.equal(a, c) for a, c in zip(first, second))}


def one_term_row(gen, b, t, h, d):
    """The single-term variant (plain TF32) beside the kernel on one draw."""
    q, k, v, _ = inputs(gen, b, t, h, d, "contiguous")
    ref, _ = A.reference_attention(q, k, v, return_lse=True)
    out, lse = A.flash_attention_f32_cuda(q, k, v, return_lse=True)
    one, one_lse = A._attention_f32_one_term(q, k, v, return_lse=True)
    dout = torch.randn(b, t, h, d, generator=gen, device="cuda")
    want = flat(plain_bwd(q, k, v, out, lse, dout))
    got = flat(A.flash_attention_bwd_f32_cuda(q, k, v, out, lse, dout))
    got1 = flat(A._attention_bwd_f32_one_term(q, k, v, out, lse, dout))
    # SDPA in float32 (TF32 off) on the same draw: float32-accurate or not
    q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(q4 * A._scale(d), k4 * A._scale(d), v4, scale=1.0)
    torch.cuda.synchronize()
    return {"shape": f"B{b} T{t} H{h} D{d}", "fwd": errors(out, ref),
            "fwd_one_term": errors(one, ref), "fwd_sdpa": errors(sdpa.permute(0, 2, 1, 3), ref),
            "bwd": errors(got, want), "bwd_one_term": errors(got1, want)}


def checks(gen, quick=False):
    rows = [check_row(gen, *c) for c in (CHECKS[:4] if quick else CHECKS)]
    rows += [one_term_row(gen, *c) for c in ONE_TERM]
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


def times(gen, quick=False):
    """Kernel, FMA kernel ("was"), plain and SDPA (TF32 off) at the paths'
    shapes, forward with the lse and backward."""
    rows = []
    for b, t, h, d, layout, what in (TIMES[:3] if quick else TIMES):
        q, k, v, qkv = inputs(gen, b, t, h, d, layout, f=2.0)
        dout = torch.randn(b, t, h, d, generator=gen, device="cuda")
        out, lse = forward(q, k, v, qkv, layout)
        if qkv is not None:
            new = layout == "new"
            fwd = {"kernel": lambda: A.qkv_attention_f32_cuda(qkv, h, new, return_lse=True),
                   "fma": lambda: A.qkv_attention_mma_cuda(qkv, h, new, return_lse=True)}
            o3, g3 = out.reshape(b, t, h * d), dout.reshape(b, t, h * d)
            bwd = {"kernel": lambda: A.qkv_attention_bwd_f32_cuda(qkv, o3, lse, g3, h, new),
                   "fma": lambda: A.qkv_attention_bwd_mma_cuda(qkv, o3, lse, g3, h, new)}
        else:
            fwd = {"kernel": lambda: A.flash_attention_f32_cuda(q, k, v, return_lse=True),
                   "fma": lambda: A.flash_attention_mma_cuda(q, k, v, return_lse=True)}
            bwd = {"kernel": lambda: A.flash_attention_bwd_f32_cuda(q, k, v, out, lse, dout),
                   "fma": lambda: A.flash_attention_bwd_mma_cuda(q, k, v, out, lse, dout)}
        q4, k4, v4 = (x.permute(0, 2, 1, 3).contiguous().requires_grad_() for x in (q, k, v))
        fwd["sdpa"] = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1 / math.sqrt(d))
        o4 = fwd["sdpa"]()
        g4 = dout.permute(0, 2, 1, 3).contiguous()
        bwd["sdpa"] = lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True)
        big = t >= 4096
        reps = 5 if big else 50
        row = {"shape": f"B{b} T{t} H{h} D{d}", "layout": layout, "what": what}
        for name, fns, ops, nbytes in (
                ("fwd", fwd, 4.0 * b * h * t * t * d, 16.0 * b * t * h * d + 4 * b * h * t),
                ("bwd", bwd, 10.0 * b * h * t * t * d, 32.0 * b * t * h * d + 4 * b * h * t)):
            ms = {n: cuda_ms(f, reps) for n, f in fns.items()}
            dev = {n: queued_ms(f, reps if big else 100) for n, f in fns.items()}
            plain = ((lambda: A.reference_attention(q, k, v, return_lse=True)) if name == "fwd"
                     else (lambda: plain_bwd(q, k, v, out, lse, dout)))
            ms["plain"] = cuda_ms(plain, 2 if big else 5, warmup=1)
            bms, by = bound_ms(ops, PEAK_TF32X3, nbytes)
            row[name] = {"ms": ms, "device_ms": dev, "bound_ms": bms, "bound_by": by}
        del q4, k4, v4, o4, g4
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def _cuobjdump():
    return os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")


def sass_of(lib: str, kernels) -> dict:
    """{kernel: its HMMA / HGMMA / FFMA counts} for the kernels named (as
    the profiler names them) in the shared library ``lib``: each kernel's
    mangled name from its host stub's symbol or its text section's name
    (``cuobjdump -ltext``), then ``cuobjdump -sass -fun``."""
    syms = [ln.split()[-1] for ln in subprocess.run(
        ["nm", "-D", "--defined-only", lib], capture_output=True, text=True,
        timeout=300).stdout.splitlines() if ln.strip()]
    out, texts = {}, None
    for kernel in kernels:
        base = kernel.split("(")[0].split()[-1]
        stub = f"__device_stub__Z{len(base)}{base}"
        mangled = next((s[len("__device_stub_"):] for s in syms if s.startswith(stub)), None)
        if mangled is None:  # not exported: the name of its text section
            if texts is None:
                texts = re.findall(r"(_Z\d+\w+)", subprocess.run(
                    [_cuobjdump(), "-ltext", lib], capture_output=True, text=True,
                    timeout=600).stdout)
            mangled = next((x for x in texts if f"Z{len(base)}{base}" in x), None)
        if mangled is None:
            out[base] = "no symbol"
            continue
        sass = subprocess.run([_cuobjdump(), "-sass", "-fun", mangled, lib],
                              capture_output=True, text=True, timeout=300).stdout
        out[base] = {op: sass.count(op) for op in ("HMMA", "HGMMA", "FFMA")}
        out[base]["HMMA_TF32"] = sass.count("HMMA.1688.F32.TF32")
    return out


def sdpa(gen, runs):
    """SDPA in float32 with TF32 off: the kernels it launches (profiler),
    their SASS where it can be found, and its backward's device time at the
    classifier's shapes, ``runs`` times."""
    from torch.profiler import ProfilerActivity, profile

    b, t, h, d = 8, 256, 4, 48
    q4, k4, v4 = (torch.randn(b, h, t, d, generator=gen, device="cuda").requires_grad_()
                  for _ in range(3))
    g4 = torch.randn(b, h, t, d, generator=gen, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1 / math.sqrt(d))
        torch.autograd.grad(o4, (q4, k4, v4), g4)
        torch.cuda.synchronize()
    kernels = sorted({e.key for e in prof.key_averages() if e.device_type.name == "CUDA"})
    res = {"kernels": kernels}
    lib = Path(torch.__file__).parent / "lib" / "libtorch_cuda.so"
    try:
        res["sass"] = sass_of(str(lib), [k for k in kernels if "fmha" in k])
    except (OSError, subprocess.SubprocessError) as err:
        res["sass"] = f"not read: {err}"
    res["bwd_device_ms"] = {}
    for shape in ((8, 256, 4, 48), (8, 64, 4, 64)):
        b, t, h, d = shape
        q4, k4, v4 = (torch.randn(b, h, t, d, generator=gen, device="cuda").requires_grad_()
                      for _ in range(3))
        g4 = torch.randn(b, h, t, d, generator=gen, device="cuda")
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1 / math.sqrt(d))
        fn = lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True)
        res["bwd_device_ms"][f"B{b} T{t} H{h} D{d}"] = [queued_ms(fn, 200) for _ in range(runs)]
    print(json.dumps(res), flush=True)
    return res


def ptxas_summary(log: str) -> dict:
    """{"fwd48": "regs/spill bytes", ...} of the three-term entry kernels in
    an nvcc -Xptxas -v log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*attn_(fwd|bwd)_tf32ILi(\d+)ELi3E", line)
        if m:
            fn = f"{m.group(1)}{m.group(2)}"
        elif "Compiling entry function" in line:
            fn = None
        elif fn and "bytes spill stores" in line:
            out[fn] = line.split(",")[1].strip().split()[0]
        elif fn and "Used" in line and "registers" in line:
            out[fn] = f"{line.split('Used')[1].split()[0]}/{out.get(fn, '0')}"
    return out


def _build_variants(names, tmp):
    """{name: the library of a copy of the source with one piece changed}."""
    src = Path(A.__file__).parent / "csrc" / _build.KERNELS[A._KERNEL_F32]
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
        print(json.dumps({"variant": name, "ptxas": ptxas_summary(log)}), flush=True)
        lib = ctypes.CDLL(str(so))
        for entry in ("eo_attention_fwd_tf32x3", "eo_attention_bwd_tf32x3"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = A._ARGTYPES[entry], ctypes.c_int
        libs[name] = lib
    return libs


def variants(gen, names):
    """Each variant's device ms against the body's, forward and backward,
    in two rounds (the second in reverse order)."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_variants(names, tmp)
        stream = lambda: torch.cuda.current_stream().cuda_stream
        for b, t, h, d in VARIANT_SHAPES:
            q, k, v, _ = inputs(gen, b, t, h, d, "contiguous", f=2.0)
            out, lse = A.flash_attention_f32_cuda(q, k, v, return_lse=True)
            dout = torch.randn_like(out)
            o2, grads = torch.empty_like(q), [torch.empty_like(q) for _ in range(3)]
            delta = torch.empty(b * h, t, device="cuda")
            s_in = A._scale_in(d, q.dtype)

            def fwd(lib):
                assert lib.eo_attention_fwd_tf32x3(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), A._strides(q, k, v),
                    o2.data_ptr(), lse.data_ptr(), 1, b, t, h, d, s_in, 0, stream()) == 0

            def bwd(lib):
                assert lib.eo_attention_bwd_tf32x3(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), *(x.data_ptr() for x in grads),
                    A._strides(q, k, v, *grads), out.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), 1, b, t, h, d, s_in, A._scale(d), 0,
                    stream()) == 0

            reps = 5 if t >= 4096 else 100
            shape = f"B{b} T{t} H{h} D{d}"
            one = {"one_term": lambda: A._attention_f32_one_term(q, k, v, return_lse=True)}
            rows.append(alternate_ms("fwd", shape, {**{n: (lambda lib=lib: fwd(lib))
                                                     for n, lib in libs.items()}, **one}, reps))
            one = {"one_term": lambda: A._attention_bwd_f32_one_term(q, k, v, out, lse, dout)}
            rows.append(alternate_ms("bwd", shape, {**{n: (lambda lib=lib: bwd(lib))
                                                     for n, lib in libs.items()}, **one}, reps))
            del q, k, v, out, lse, dout, o2, grads, delta
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="a few checks and shapes only")
    ap.add_argument("--runs", type=int, default=5, help="runs of SDPA's backward timing")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated variants to time ({', '.join(VARIANTS)}; empty: none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn_f32 needs a CUDA device")
    names = [n for n in args.variants.split(",") if n]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {sorted(VARIANTS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    res = {"card": card_line(), "checks": checks(gen, args.quick),
           "times": times(gen, args.quick), "sdpa": sdpa(gen, args.runs),
           "variants": variants(gen, names) if names else []}
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return res


if __name__ == "__main__":
    main()
