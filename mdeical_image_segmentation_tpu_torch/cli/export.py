"""Export a saved bundle to a deployment artifact (the JAX package's
``cli/export.py``).

Traces the inference forward with ``torch.export`` (parameters inside) into
``model.pt2`` beside ``export_meta.json`` (``export.py``).  The artifact
loads with ``export.load_exported`` — or ``cli.serve --exported
name=...,path=...`` — without any model code.  It keeps the device it was
traced on (``--device``, default ``cuda``).

Examples::

    python -m mdeical_image_segmentation_tpu_torch.cli.export \\
        --model_dir runs/unet/final --output artifacts/unet \\
        --resolution 512 512
    python -m mdeical_image_segmentation_tpu_torch.cli.export \\
        --model_dir runs/unet3d/final --output artifacts/u3d \\
        --patch 32 64 64 --batch 1 --compute_dtype bfloat16
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", required=True,
                   help="bundle dir (config.json + params.msgpack)")
    p.add_argument("--output", required=True, help="artifact output dir")
    p.add_argument("--batch", type=int, default=None,
                   help="pin the batch size (default: symbolic 'b')")
    p.add_argument("--resolution", type=int, nargs=2, default=(512, 512),
                   metavar=("H", "W"), help="2D input resolution")
    p.add_argument("--patch", type=int, nargs=3, default=(32, 64, 64),
                   metavar=("D", "H", "W"), help="3D input patch shape")
    p.add_argument("--device", default="cuda",
                   help="device to trace and run on (default: cuda)")
    p.add_argument("--logits", action="store_true",
                   help="emit raw logits instead of probabilities")
    p.add_argument("--compute_dtype", default=None,
                   choices=(None, "float32", "bfloat16"),
                   help="override the bundle's conv compute dtype")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..export import META_FILE, export_bundle

    out = export_bundle(
        args.model_dir,
        args.output,
        batch=args.batch,
        resolution=tuple(args.resolution),
        patch_shape=tuple(args.patch),
        device=args.device,
        output="logits" if args.logits else "probs",
        compute_dtype=args.compute_dtype,
    )
    with open(os.path.join(out, META_FILE)) as f:
        print(json.dumps(json.load(f)))


if __name__ == "__main__":
    main()
