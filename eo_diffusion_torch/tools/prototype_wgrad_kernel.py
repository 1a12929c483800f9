"""The 3x3 conv weight-gradient kernel on the GPU, beside its plain version,
cuDNN and the card's bound.

    python -m eo_diffusion_torch.tools.prototype_wgrad_kernel [--sites unet256]
        [--device cpu] [--out results/wgrad.json]

The port of the JAX package's prototype (``tools/prototype_wgrad_kernel.py``).
Its default is that tool's shape: x and dy ``[8, 256, 256, 128]`` bf16 (B8,
256 x 256, C 128 -> 128). ``--sites unet256`` instead sweeps every stride-1
3x3 conv of a ``sen12mscr256`` UNet training step at batch 8 (49 sites in 22
shapes, the input conv C 6 -> 128 and the output conv 128 -> 3 among them):
it builds the port's UNet from seeded random weights, runs one loss and
backward, captures x and dy at each site with hooks and holds the kernel
against cuDNN's weight gradient (the conv weight's ``.grad``) there.

At each shape it reports the kernel's time (CUDA events after warm-up), the
plain version's, the library's (cuDNN's weight gradient alone,
``aten.convolution_backward`` with only the weight's gradient asked for, on
the NCHW view of channels-last bf16 as the port's ``Conv`` reaches it), the
card's bound and the kernel's largest error against the plain version; the
sweep adds the sums over its sites. Prints one JSON line (with the card's
name and power limit); writes it to ``--out`` only when given. Needs a CUDA
device unless given ``--device cpu``, which runs the plain version at a
tiny shape against PyTorch's own conv gradient (for the tests).
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.nn.functional as F

from eo_diffusion_torch.ops import conv_wgrad as CW
from eo_diffusion_torch.tools.timing import PEAK_BF16, PEAK_F32, bound_ms, card_line, cuda_ms

B, H, W, C = 8, 256, 256, 128  # the JAX tool's shape
UNET_BATCH = 8
SWEEP_REPS = 10
PEAK = {torch.bfloat16: PEAK_BF16, torch.float32: PEAK_F32}


def flops(b: int, h: int, w: int, c: int, co: int) -> float:
    return 2.0 * b * h * w * 9 * c * co


def wgrad_bound_ms(b: int, h: int, w: int, c: int, co: int, dtype: torch.dtype):
    """The card's least time: the products at the dtype's peak, or x and dy
    read once and dW (f32) written once; (ms, "operations" or "bytes")."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * b * h * w * (c + co) + 4 * 9 * c * co
    return bound_ms(flops(b, h, w, c, co), PEAK[dtype], nbytes)


def library_wgrad(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """cuDNN's weight gradient alone, ``[Co, C, 3, 3]`` in x's dtype, on the
    NCHW views of NHWC x and dy, as the port's ``Conv`` backward reaches it."""
    return torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight, None, [1, 1], [1, 1], [1, 1],
        False, [0, 0], 1, [False, True, False])[1]


def measure(x: torch.Tensor, dy: torch.Tensor, reps: int = SWEEP_REPS) -> dict:
    """Kernel, plain and library times and the kernel's error against the
    plain version at one shape (CUDA tensors); one row."""
    b, h, w, c = x.shape
    co = dy.shape[-1]
    got = CW.conv_wgrad_cuda(x, dy)
    ref = CW.conv_wgrad_reference(x, dy)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    del got, ref
    weight = torch.empty(co, c, 3, 3, dtype=x.dtype, device=x.device)
    bound, by = wgrad_bound_ms(b, h, w, c, co, x.dtype)
    return {"shape": f"B{b} {h}x{w} C{c}->{co}", "dtype": str(x.dtype).split(".")[-1],
            "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
            "kernel_ms": cuda_ms(lambda: CW.conv_wgrad_cuda(x, dy), reps),
            "plain_ms": cuda_ms(lambda: CW.conv_wgrad_reference(x, dy), 1, warmup=1),
            "library_ms": cuda_ms(lambda: library_wgrad(x, dy, weight), reps),
            "bound_ms": bound, "bound_by": by, "gflop": flops(b, h, w, c, co) / 1e9}


def capture_unet_sites(seed: int = 0):
    """One ``sen12mscr256`` training loss and backward at batch 8 from
    seeded random weights (bf16, the port's kernels on): returns, for every
    stride-1 3x3 conv in forward order, ``(name, x, dy, grad)`` with x and dy
    the NHWC bf16 tensors its weight gradient contracts and grad the conv
    weight's ``.grad`` (cuDNN's, ``[Co, C, 3, 3]`` f32)."""
    from eo_diffusion_torch.cli.presets import get_preset
    from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
    from eo_diffusion_torch.models.unet import UNet
    from eo_diffusion_torch.nn.primitives import Conv
    from eo_diffusion_torch.weights import randomize_parameters

    dev = torch.device("cuda")
    cfg = get_preset("sen12mscr256").unet_config(cond_channels=3)
    model = randomize_parameters(UNet(cfg), seed).to(dev).train()
    diffusion = GaussianDiffusion.create(timesteps=1000, image_size=cfg.image_size,
                                         cond_type="concat")
    g = torch.Generator(device=dev).manual_seed(seed)
    size = cfg.image_size
    x0, cond, noise = (torch.randn(UNET_BATCH, size, size, 3, generator=g, device=dev)
                       for _ in range(3))
    t = torch.randint(0, 1000, (UNET_BATCH,), generator=g, device=dev)
    seen, hooks = [], []

    def grab(mod, inputs, output):
        rec = {"name": mod.site, "x": inputs[0].detach().to(mod.compute_dtype).contiguous()}
        output.register_hook(lambda gy: rec.__setitem__("dy", gy.detach().contiguous()))
        seen.append((rec, mod))

    for name, mod in model.named_modules():
        if isinstance(mod, Conv) and mod.kernel_size == (3, 3) and mod.stride == (1, 1):
            mod.site = name
            hooks.append(mod.register_forward_hook(grab))
    try:
        loss = diffusion.train_loss(lambda xx, tt, c, y: model(xx, tt, cond=c, y=y), x0,
                                    cond=cond, noise=noise, t=t)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        for hk in hooks:
            hk.remove()
    return [(rec["name"], rec["x"], rec["dy"], mod.weight.grad.detach().clone())
            for rec, mod in seen]


def run_sites(seed: int = 0) -> dict:
    """The sweep over the UNet's stride-1 3x3 sites: per site the kernel
    against cuDNN's ``.grad`` and :func:`measure`, then the sums."""
    sites = capture_unet_sites(seed)
    rows = []
    for name, x, dy, grad in sites:
        got = CW.hwio_to_oihw(CW.conv_wgrad_cuda(x, dy))
        torch.cuda.synchronize()
        diff = (got - grad).abs().max().item()
        row = {"site": name, **measure(x, dy), "cudnn_max_abs_err": diff,
               "cudnn_max_rel_err": diff / max(grad.abs().max().item(), 1e-30)}
        rows.append(row)
    del sites
    sums = {k: sum(r[k] for r in rows) for k in ("kernel_ms", "plain_ms", "library_ms",
                                                 "bound_ms", "gflop")}
    return {"sites": len(rows), "distinct_shapes": len({r["shape"] for r in rows}),
            "sums": sums, "max_cudnn_rel_err": max(r["cudnn_max_rel_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows), "rows": rows}


def run_cpu(seed: int = 0) -> dict:
    """The plain version at a tiny f32 shape against PyTorch's own conv
    weight gradient (autograd through ``F.conv2d``)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 9, 7, 5, generator=g)
    dy = torch.randn(2, 9, 7, 6, generator=g)
    w = torch.zeros(6, 5, 3, 3, requires_grad=True)
    want = torch.autograd.grad(F.conv2d(x.permute(0, 3, 1, 2), w, padding=1), w,
                               dy.permute(0, 3, 1, 2))[0]
    got = CW.hwio_to_oihw(CW.conv_wgrad(x, dy))
    return {"device": "cpu", "shape": "B2 9x7 C5->6", "dtype": "float32",
            "max_abs_err_vs_autograd": (got - want).abs().max().item(),
            "max_abs": want.abs().max().item()}


def run(sites: str | None = None, device: str = "cuda", seed: int = 0) -> dict:
    if device == "cpu":
        return run_cpu(seed)
    if not torch.cuda.is_available():
        raise SystemExit("prototype_wgrad_kernel: needs a CUDA device (or --device cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"card": card_line()}
    if sites == "unet256":
        res.update(run_sites(seed))
        return res
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, dy = (torch.randn(B, H, W, C, generator=g, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    res.update(measure(x, dy))
    res["kernel_tflops"] = res["gflop"] / res["kernel_ms"]
    res["library_tflops"] = res["gflop"] / res["library_ms"]
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", choices=["unet256"], default=None,
                    help="sweep the stride-1 3x3 convs of a sen12mscr256 training step")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    res = run(args.sites, args.device, args.seed)
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
