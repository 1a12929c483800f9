"""The 3x3 conv weight-gradient kernels on the GPU, beside their plain
version, cuDNN and the card's bound.

    python -m eo_diffusion_torch.tools.prototype_wgrad_kernel
        [--sites unet256|unet512] [--device cpu] [--out results/wgrad.json]

The port of the JAX package's prototype (``tools/prototype_wgrad_kernel.py``).
Its default is that tool's shape: x and dy ``[8, 256, 256, 128]`` bf16 (B8,
256 x 256, C 128 -> 128). ``--sites unet256`` instead sweeps every stride-1
3x3 conv of a ``sen12mscr256`` UNet training step at batch 8 (49 sites in 22
shapes, the input conv C 6 -> 128 and the output conv 128 -> 3 among them);
``--sites unet512`` the same 49 convs at ``--image_size 512``, batch 4 (the
512 px training shape). A sweep builds the port's UNet from seeded random
weights with its convs on cuDNN's autograd (``set_impl(conv="plain")``), runs
one loss and backward, captures x and dy at each site with hooks and holds
both kernels against cuDNN's weight gradient (the conv weight's ``.grad``)
there.

At each shape it reports the ``wgmma`` body's time (``sm90_ms``, where it
takes the shape: bf16, C and Co multiples of 8), the ``mma.sync`` body's
(``kernel_ms``), the plain version's, the library's (cuDNN's weight gradient
alone, ``aten.convolution_backward`` with only the weight's gradient asked
for, on the NCHW view of channels-last bf16 as the port's ``Conv`` reaches
it), the card's bound, each kernel's largest error against the plain version
and ``ops.conv_wgrad.wgrad_route``'s pick. A sweep adds the sums over its
sites, ``routed_ms`` being what the route's picks take. Times are CUDA events
over back-to-back calls after warm-up; ``*_host_us`` is the host's time to
enqueue one call. Prints one JSON line (with the card's
name and power limit); writes it to ``--out`` only when given. Needs a CUDA
device unless given ``--device cpu``, which runs the plain version at a
tiny shape against PyTorch's own conv gradient (for the tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.nn.functional as F

from eo_diffusion_torch.ops import conv_wgrad as CW
from eo_diffusion_torch.tools.timing import PEAK_BF16, PEAK_F32, bound_ms, card_line, cuda_ms

B, H, W, C = 8, 256, 256, 128  # the JAX tool's shape
# --sites: (image size, batch) of the training step swept
SWEEPS = {"unet256": (256, 8), "unet512": (512, 4)}
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
    """Both kernels' times and errors against the plain version, the plain,
    library and bound times, and the route's pick at one shape (CUDA
    tensors); one row. ``sm90_*`` only where the ``wgmma`` body takes the
    shape (bf16, C and Co multiples of 8)."""
    b, h, w, c = x.shape
    co = dy.shape[-1]
    ref = CW.conv_wgrad_reference(x, dy)
    scale = ref.abs().max().item()
    got = CW.conv_wgrad_cuda(x, dy)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    row = {"shape": f"B{b} {h}x{w} C{c}->{co}", "dtype": str(x.dtype).split(".")[-1],
           "route": CW.wgrad_route(b, h, w, c, co, x.dtype),
           "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30)}
    if x.dtype == torch.bfloat16 and c % 8 == 0 and co % 8 == 0:
        got = CW.conv_wgrad_sm90_cuda(x, dy)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        row.update(sm90_max_abs_err=err, sm90_max_rel_err=err / max(scale, 1e-30),
                   sm90_ms=cuda_ms(lambda: CW.conv_wgrad_sm90_cuda(x, dy), reps),
                   sm90_host_us=host_us(lambda: CW.conv_wgrad_sm90_cuda(x, dy)))
    del got, ref
    weight = torch.empty(co, c, 3, 3, dtype=x.dtype, device=x.device)
    bound, by = wgrad_bound_ms(b, h, w, c, co, x.dtype)
    row.update(kernel_ms=cuda_ms(lambda: CW.conv_wgrad_cuda(x, dy), reps),
               plain_ms=cuda_ms(lambda: CW.conv_wgrad_reference(x, dy), 1, warmup=1),
               library_ms=cuda_ms(lambda: library_wgrad(x, dy, weight), reps),
               library_host_us=host_us(lambda: library_wgrad(x, dy, weight)),
               bound_ms=bound, bound_by=by, gflop=flops(b, h, w, c, co) / 1e9)
    return row


def host_us(fn, reps: int = 5) -> float:
    """Microseconds of host time a call of ``fn`` takes to enqueue its work
    (the device queue drained first, so no call waits for room)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def routed_ms(row: dict) -> float:
    """The time of the route's pick in a :func:`measure` row."""
    return {"sm90": row.get("sm90_ms"), "mma": row["kernel_ms"],
            "cudnn": row["library_ms"]}[row["route"]]


def delta_check(b: int, h: int, w: int, c: int, co: int, gen: torch.Generator) -> dict:
    """The nine taps of the ``wgmma`` body held apart: dy is zero except a 1
    at a few pixels (corners, tile edges, the interior), each in its own
    output channel, and x holds distinct bf16 values, so dW[ky, kx, :, o] is
    exactly the x pixel (or padding zero) at offset (ky - 1, kx - 1) of the
    pixel of channel o. Returns the taps that differ from that (none when
    right) and the number of output channels checked."""
    x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
    pts = [(0, 0, 0), (b - 1, h - 1, w - 1), (0, h - 1, 0), (b - 1, 0, w - 1),
           (0, 7, 15), (0, 8, 16), (b - 1, 7, 16), (0, 8, 15), (b - 1, h // 2, w // 2),
           (0, 9, 17)]
    pts = list(dict.fromkeys((bi, min(hi, h - 1), min(wi, w - 1)) for bi, hi, wi in pts))[:co]
    dy = torch.zeros(b, h, w, co, dtype=torch.bfloat16, device="cuda")
    want = torch.zeros(3, 3, c, co, dtype=torch.float32, device="cuda")
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    for o, (bi, hi, wi) in enumerate(pts):
        dy[bi, hi, wi, o] = 1
        want[:, :, :, o] = xp[bi, hi:hi + 3, wi:wi + 3]
    got = CW.conv_wgrad_sm90_cuda(x, dy)
    torch.cuda.synchronize()
    wrong = [(ky, kx) for ky in range(3) for kx in range(3)
             if not torch.equal(got[ky, kx], want[ky, kx])]
    return {"shape": f"B{b} {h}x{w} C{c}->{co}", "deltas": len(pts), "wrong_taps": wrong,
            "exact": not wrong}


def _site_config(size: int):
    from eo_diffusion_torch.cli.presets import get_preset

    cfg = get_preset("sen12mscr256").unet_config(cond_channels=3)
    return dataclasses.replace(cfg, image_size=size)


def _routed_convs(model):
    from eo_diffusion_torch.nn.primitives import Conv

    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, Conv) and mod.kernel_size == (3, 3) and mod.stride == (1, 1)]


def site_shapes(size: int = 256, batch: int = 8, cfg=None) -> list:
    """``(name, B, H, W, C, Co)`` of every stride-1 3x3 conv of a UNet
    forward at ``size`` px (``cfg``'s UNet, by default ``sen12mscr256``'s),
    in forward order, from a forward on the meta device (shapes only)."""
    from eo_diffusion_torch.models.unet import UNet

    cfg = _site_config(size) if cfg is None else dataclasses.replace(cfg, image_size=size)
    with torch.device("meta"):
        model = UNet(cfg)
    model.set_impl(attn="plain", norm="plain")
    seen, hooks = [], []
    for name, mod in _routed_convs(model):
        hooks.append(mod.register_forward_hook(
            lambda m, args, out, name=name: seen.append((name, *args[0].shape,
                                                         out.shape[-1]))))
    try:
        with torch.inference_mode():
            x = torch.zeros(batch, size, size, cfg.in_channels, device="meta", dtype=cfg.dtype)
            model(x, torch.zeros(batch, dtype=torch.long, device="meta"))
    finally:
        for hk in hooks:
            hk.remove()
    return seen


def capture_unet_sites(seed: int = 0, size: int = 256, batch: int = 8):
    """One ``sen12mscr256`` training loss and backward at ``size`` px from
    seeded random weights (bf16, the attention and GroupNorm kernels on, the
    convs on cuDNN's autograd): returns, for every stride-1 3x3 conv in
    forward order, ``(name, x, dy, grad)`` with x and dy the NHWC bf16
    tensors its weight gradient contracts and grad the conv weight's
    ``.grad`` (cuDNN's, ``[Co, C, 3, 3]`` f32)."""
    from eo_diffusion_torch.diffusion.gaussian import GaussianDiffusion
    from eo_diffusion_torch.models.unet import UNet
    from eo_diffusion_torch.weights import randomize_parameters

    dev = torch.device("cuda")
    cfg = _site_config(size)
    model = randomize_parameters(UNet(cfg), seed).to(dev).train().set_impl(conv="plain")
    diffusion = GaussianDiffusion.create(timesteps=1000, image_size=cfg.image_size,
                                         cond_type="concat")
    g = torch.Generator(device=dev).manual_seed(seed)
    x0, cond, noise = (torch.randn(batch, size, size, 3, generator=g, device=dev)
                       for _ in range(3))
    t = torch.randint(0, 1000, (batch,), generator=g, device=dev)
    seen, hooks = [], []

    def grab(mod, inputs, output):
        rec = {"name": mod.site, "x": inputs[0].detach().to(mod.compute_dtype).contiguous()}
        output.register_hook(lambda gy: rec.__setitem__("dy", gy.detach().contiguous()))
        seen.append((rec, mod))

    for name, mod in _routed_convs(model):
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


def _cudnn_errors(got: torch.Tensor, grad: torch.Tensor, prefix: str) -> dict:
    diff = (CW.hwio_to_oihw(got) - grad).abs().max().item()
    return {f"{prefix}max_abs_err": diff,
            f"{prefix}max_rel_err": diff / max(grad.abs().max().item(), 1e-30)}


def run_sites(seed: int = 0, sweep: str = "unet256") -> dict:
    """The sweep over the UNet's stride-1 3x3 sites: per site both kernels
    against cuDNN's ``.grad`` and :func:`measure`, then the sums."""
    size, batch = SWEEPS[sweep]
    sites = capture_unet_sites(seed, size, batch)
    rows = []
    for name, x, dy, grad in sites:
        row = {"site": name, **_cudnn_errors(CW.conv_wgrad_cuda(x, dy), grad, "cudnn_")}
        if x.shape[-1] % 8 == 0 and dy.shape[-1] % 8 == 0:
            row.update(_cudnn_errors(CW.conv_wgrad_sm90_cuda(x, dy), grad, "sm90_cudnn_"))
        row.update(measure(x, dy))
        row["routed_ms"] = routed_ms(row)
        rows.append(row)
    del sites
    sums = {k: sum(r[k] for r in rows) for k in ("kernel_ms", "plain_ms", "library_ms",
                                                 "bound_ms", "gflop", "routed_ms")}
    taken = [r for r in rows if "sm90_ms" in r]
    sums["sm90_ms"] = sum(r["sm90_ms"] for r in taken)
    sums["library_ms_where_sm90_takes"] = sum(r["library_ms"] for r in taken)
    routes = {k: sum(r["route"] == k for r in rows) for k in ("sm90", "mma", "cudnn")}
    return {"sweep": sweep, "image_size": size, "batch": batch, "sites": len(rows),
            "distinct_shapes": len({r["shape"] for r in rows}), "sites_sm90_takes": len(taken),
            "routes": routes, "sums": sums,
            "max_cudnn_rel_err": max(r["cudnn_max_rel_err"] for r in rows),
            "max_sm90_cudnn_rel_err": max(r["sm90_cudnn_max_rel_err"] for r in taken),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "max_sm90_rel_err": max(r["sm90_max_rel_err"] for r in taken), "rows": rows}


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
    if sites is not None:
        res.update(run_sites(seed, sites))
        return res
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, dy = (torch.randn(B, H, W, C, generator=g, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    res.update(measure(x, dy))
    for k in ("sm90", "kernel", "library"):
        res[f"{k}_tflops"] = res["gflop"] / res[f"{k}_ms"]
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", choices=sorted(SWEEPS), default=None,
                    help="sweep the stride-1 3x3 convs of a sen12mscr256 training step "
                         "(256 px batch 8, or 512 px batch 4)")
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
