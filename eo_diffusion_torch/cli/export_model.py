"""Export CLI of the port: package a model as a self-contained
``torch.export`` artifact (counterpart of
``eo_diffusion_tpu/cli/export_model.py``).

``python -m eo_diffusion_torch.cli.export_model --preset sen12mscr256
--ckpt logs/run/best --out artifacts/clouds --sampler ddim --sampler_steps 10``

Builds the engine ``cli.serve`` would run (same presets, checkpoint loading,
guidance, int8 packing), then exports its program and weights with
``serving/export.py``. The artifact carries the device it was exported on
(``--device``, the card unless ``--device cpu``). ``--run`` loads the
artifact back from disk, runs one batch through the loaded program and
writes ``smoke.png``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a sampler as a torch.export artifact")
    p.add_argument("--preset", type=str, default="clouds64-attn")
    p.add_argument("--ckpt", type=str, default="",
                   help="port checkpoint (EMA exported) or reference .pt; empty = seeded "
                        "fresh init (smoke only)")
    p.add_argument("--out", type=str, required=True, help="artifact directory to write")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--sampler", type=str, default="ddim",
                   choices=["ddpm", "ddim", "dpm", "unipc", "flow", "bridge"])
    p.add_argument("--sampler_steps", type=int, default=50)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--ddim_spacing", type=str, default="uniform",
                   choices=["uniform", "quad", "trailing"])
    p.add_argument("--flow_method", type=str, default="euler", choices=["euler", "heun"])
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--pag_scale", type=float, default=0.0,
                   help="bake perturbed-attention guidance (arXiv:2403.17377) into the "
                        "exported program")
    p.add_argument("--guidance_rescale", type=float, default=0.0)
    p.add_argument("--guidance_interval", type=str, default=None, metavar="LO,HI")
    p.add_argument("--num_classes", type=int, default=0)
    p.add_argument("--class_dropout", type=float, default=0.0)
    p.add_argument("--cond_type", type=str, default=None)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--no_bf16", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="export weight-only int8 params (W8A16): the int8 leaves and scales "
                        "land in params.npz and the dequantization runs inside the program")
    p.add_argument("--int8_compute", action="store_true",
                   help="export the W8A8 route (nn/primitives.int8_dense_compute)")
    p.add_argument("--ae_ckpt", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu: the device the artifact runs on")
    p.add_argument("--run", action="store_true",
                   help="load the artifact from disk and run one batch through the loaded "
                        "program (writes smoke.png)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(args):
    """Export (and with ``--run`` sample once); returns the manifest, with
    the loaded batch as ``"samples"`` after ``--run``."""
    import os

    from eo_diffusion_torch.cli import serve as serve_cli
    from eo_diffusion_torch.serving.export import export_engine, load_model

    # the exported engine IS the serving engine: cli.serve's build_engine, with
    # the serve CLI's defaults for everything this CLI does not expose
    base = serve_cli.parse_args(["--preset", args.preset])
    for k, v in vars(args).items():
        if hasattr(base, k):
            setattr(base, k, v)
    engine, batcher, meta = serve_cli.build_engine(base)
    batcher.shutdown()  # packaging only: no request worker needed
    manifest = export_engine(engine, args.out, extra_meta=meta)
    print(f"exported {manifest['param_bytes'] / 1e6:.1f} MB params + "
          f"{manifest['sampler']}-{manifest['steps']} sampler ({manifest['graph_nodes']} "
          f"nodes, {manifest['export_seconds']:.1f}s, device {manifest['device']}) -> "
          f"{args.out}")
    if args.run:
        from eo_diffusion_torch.utils.images import rescale_to_unit, save_image_grid

        generate, man = load_model(args.out)
        out = generate(args.seed)
        png = os.path.join(args.out, "smoke.png")
        save_image_grid(rescale_to_unit(out, tuple(man.get("data_range", (0.0, 1.0)))), png)
        print(f"smoke batch {out.shape} from the loaded program -> {png}")
        manifest = dict(manifest, samples=out, load_seconds=man["load_seconds"])
    return manifest


if __name__ == "__main__":
    main(parse_args())
