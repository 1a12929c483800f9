"""What each piece of the wgmma/TMA attention forward costs, on the GPU.

    python -m eo_diffusion_torch.tools.profile_attn_fwd_sm90 [--out results/fwd_sm90.json]

Builds copies of ``csrc/attention_fwd_sm90.cu`` with one piece changed and
times each against the body as built (CUDA events, alternating order, median
of four rounds) at the clouds UNet's and the DiT's shapes, through the
port's separate-tensor entry on the ``split_qkv`` views:

* ``d48_padded``: D 48 padded to one 64-column chunk (``kD48Chunks16``
  false) instead of three unpadded 16-column chunks;
* ``no_k_scale``: the producer warps do not scale K by s (wrong on purpose);
* ``no_exp``: ex2 replaced by a move (wrong on purpose);
* ``no_softmax``: tiles after the first skip the softmax (max, exp, sums;
  wrong on purpose);
* ``no_products``: tiles after the first issue no QKᵀ and no PV (wrong on
  purpose): what the loads, the k scaling, the softmax and the
  synchronisation take alone;
* ``no_turns``: the two consumer warpgroups issue their products without
  taking turns through the named barriers;
* ``two_stages``, ``three_stages``: a K/V ring of at most 2 or 3 stages
  instead of 4 (as many as fit in shared memory);
* ``bk64``: 64 keys a stage up to D 128 instead of 128.

Each row gives the variant's time, the body's, their ratio and the variant's
error against the plain version (``probe_packed_pv.attention_errors``; the
wrong variants are far off by design). Prints one JSON line with the
card's name and power limit; writes it to ``--out`` only when given. Needs a
CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
from pathlib import Path

import torch

from eo_diffusion_torch.ops import _build
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.tools.probe_packed_pv import attention_errors
from eo_diffusion_torch.tools.timing import card_line, cuda_ms

KERNEL = "attention_fwd_sm90"
#: variant -> (text of the source, its replacement)
VARIANTS = {
    "d48_padded": ("constexpr bool kD48Chunks16 = true;", "constexpr bool kD48Chunks16 = false;"),
    "no_k_scale": ("scale_tile(stage_k(s), Tl::KV_BYTES / 16, i, kScalers, s2);", ""),
    "no_exp": ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x;"),
    "no_softmax": ("softmax(j, alpha);", "alpha[0] = alpha[1] = 1.f;"),
    "no_products": ("issue_qk<DP, AW>(sc, sq, stage_k(s));\n      wgmma_commit();\n"
                    "      issue_pv<DP, AW>(o, pa, stage_v(sp));", ""),
    "no_turns": ("named_sync(my_turn, 256);", ""),
    "two_stages": ("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 2;"),
    "three_stages": ("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 3;"),
    "bk64": ("DP <= 128 ? 128 : 64;", "DP <= 128 ? 64 : 64;"),
}
#: (B, T, H, D): the clouds UNet at 256 px (ds 4, ds 8), the dit256 attention,
#: the 512 px ds-4 attention
SHAPES = ((8, 4096, 8, 48), (8, 1024, 8, 64), (8, 1024, 12, 64), (8, 16384, 8, 48))


def variant_source(name: str) -> str:
    """The body's source with the variant's one change."""
    src = (_build._CSRC / f"{KERNEL}.cu").read_text()
    old, new = VARIANTS[name]
    if old not in src:
        raise RuntimeError(f"variant {name}: its text is not in the source any more")
    out = src.replace(old, new)
    if name == "no_turns":  # and no arrivals on the barriers nobody waits at
        out = out.replace("named_arrive(other_turn, 256);", "(void)0;")
    return out


def build_variants(sources: dict, workdir: Path) -> dict:
    """One ``nvcc`` a variant (name -> its source text), all started
    together; name -> loaded library."""
    procs = {}
    for name, text in sources.items():
        src = workdir / f"{name}.cu"
        src.write_text(text)
        lib = workdir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def run(seed: int = 0, variants=tuple(VARIANTS), shapes=SHAPES, rounds: int = 4) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn_fwd_sm90: needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"body": _build.load(KERNEL),
                **build_variants({n: variant_source(n) for n in variants}, Path(tmp))}

        def use(name):  # route the wrapper's bf16 launches to one library
            _build._loaded[KERNEL] = libs[name]

        g = torch.Generator(device="cuda").manual_seed(seed)
        res = {"card": card_line(), "rows": []}
        try:
            for b, t, h, d in shapes:
                qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(torch.bfloat16)
                q, k, v = A.split_qkv(qkv, h)
                ref = A.reference_attention(q, k, v) if t <= 4096 else None
                reps = 5 if t > 4096 else 20
                times = {n: [] for n in libs}
                errs = {}
                for n in libs:
                    use(n)
                    out = A.flash_attention_cuda(q, k, v)
                    if ref is not None:
                        errs[n] = attention_errors(out, ref)["max_rms_scaled_err"]
                for i in range(rounds):
                    for n in (list(libs) if i % 2 == 0 else list(libs)[::-1]):
                        use(n)
                        times[n].append(cuda_ms(lambda: A.flash_attention_cuda(q, k, v), reps))
                med = {n: sorted(x)[len(x) // 2] for n, x in times.items()}
                for n in variants:
                    res["rows"].append({"shape": f"B{b} T{t} H{h} D{d}", "variant": n,
                                        "ms": med[n], "body_ms": med["body"],
                                        "vs_body": med[n] / med["body"],
                                        "max_rms_scaled_err": errs.get(n)})
                del qkv, ref
        finally:
            use("body")
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
