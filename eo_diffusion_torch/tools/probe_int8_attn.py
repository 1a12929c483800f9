"""W8A8 attention probe on the GPU: does int8 QK^T/PV pay end to end?

    python -m eo_diffusion_torch.tools.probe_int8_attn [--out results/int8_attn_probe.json]

The port of the JAX package's probe (``tools/probe_int8_attn.py``), at its
shapes: the attention of a DiT-B/4 on the latent256 grid (batch 32, 12 heads,
256 tokens, head dim 64, bf16). Three measurements on the card:

1. the int8 core's largest error against the f32 core, relative to the f32
   core's largest value;
2. core times (CUDA events) of the plain bf16 core, the port's bf16 attention
   kernel (``flash_attention_cuda``, the separate-tensor entry, and
   ``qkv_attention_cuda``, the fused-qkv entry the DiT calls), the int8
   kernel, each beside the card's bound, and
   ``F.scaled_dot_product_attention`` for reference (timed only);
3. the Amdahl share: one DiT-B/4 call of the port at the latent256 shape
   (4 channels, 64 x 64, batch 32, bf16, seeded random weights), the
   fused-qkv core's time x depth over the call's time, and the end-to-end
   ceiling ``share * (1 - 1/speedup)`` of the int8 core in its place.

Prints one JSON line; writes it to ``--out`` only when given. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch
import torch.nn.functional as F

from eo_diffusion_torch.models.dit import DiT, DiTConfig
from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.ops import int8_attention as I8
from eo_diffusion_torch.tools.timing import PEAK_BF16, PEAK_INT8, bound_ms, card_line, cuda_ms
from eo_diffusion_torch.weights import randomize_parameters

B, H, T, D = 32, 12, 256, 64
DEPTH = 12


def core_f32(q, k, v):
    """softmax(q k^T / sqrt(D)) v in f32 (the probe's reference)."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * q.shape[-1] ** -0.5
    return torch.bmm(torch.softmax(s, dim=-1), v.float())


def core_plain_bf16(q, k, v):
    """The plain bf16 core: bf16 products, f32 softmax."""
    s = torch.bmm(q, k.transpose(1, 2)).float() * q.shape[-1] ** -0.5
    return torch.bmm(torch.softmax(s, dim=-1).to(v.dtype), v)


def run(seed: int = 0) -> dict:
    """The three measurements; returns the result dict."""
    if not torch.cuda.is_available():
        raise SystemExit("probe_int8_attn: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B * H, T, D, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    res = {"card": card_line(),
           "shapes": {"B": B, "H": H, "T": T, "D": D, "dtype": "bfloat16"}}

    # 1. numerics: the int8 core against the f32 core
    ref = core_f32(q, k, v)
    got = I8.int8_attention(q, k, v).float()
    res["int8_core_max_rel_err"] = ((got - ref).abs().max() / ref.abs().max()).item()
    del ref, got

    # 2. core times beside their bounds
    def views(x):  # [B*H, T, D] -> [B, T, H, D] strided view
        return x.reshape(B, H, T, D).permute(0, 2, 1, 3)

    qkv = torch.cat([views(x).reshape(B, T, H * D) for x in (q, k, v)], dim=-1)  # new order
    q4, k4, v4 = (x.reshape(B, H, T, D) for x in (q, k, v))
    times = {
        "core_plain_bf16_ms": cuda_ms(lambda: core_plain_bf16(q, k, v)),
        "core_flash_bf16_ms": cuda_ms(lambda: A.flash_attention_cuda(views(q), views(k),
                                                                     views(v))),
        "core_qkv_bf16_ms": cuda_ms(lambda: A.qkv_attention_cuda(qkv, H, new_order=True)),
        "core_int8_ms": cuda_ms(lambda: I8.int8_attention(q, k, v)),
        "core_sdpa_bf16_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0 / math.sqrt(D))),
    }
    res.update(times)
    nbytes = 4 * B * H * T * D * 2  # q, k, v read and o written once, bf16
    ops = 4.0 * B * H * T * T * D
    res["bound_bf16_ms"], res["bound_bf16_by"] = bound_ms(ops, PEAK_BF16, nbytes)
    res["bound_int8_ms"], res["bound_int8_by"] = bound_ms(ops, PEAK_INT8, nbytes)
    res["int8_speedup_vs_qkv_kernel"] = times["core_qkv_bf16_ms"] / times["core_int8_ms"]
    res["int8_speedup_vs_plain"] = times["core_plain_bf16_ms"] / times["core_int8_ms"]

    # 3. Amdahl: one DiT-B/4 call at the latent256 shape
    cfg = DiTConfig(image_size=64, in_channels=4, out_channels=4, patch_size=4,
                    hidden_size=768, depth=DEPTH, num_heads=H, dtype=torch.bfloat16)
    model = randomize_parameters(DiT(cfg), seed).to(dev).eval()
    x = torch.randn(B, 64, 64, 4, generator=g, device=dev)
    tt = torch.full((B,), 500.0, device=dev)
    with torch.inference_mode():
        res["dit_call_ms"] = cuda_ms(lambda: model(x, tt), reps=10)
    share = times["core_qkv_bf16_ms"] * DEPTH / res["dit_call_ms"]
    res["attn_core_share"] = share
    res["e2e_ceiling_pct"] = 100.0 * share * (1.0 - 1.0 / res["int8_speedup_vs_qkv_kernel"])
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
