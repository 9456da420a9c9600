"""Serving CLI of the port: segmentation-as-a-service on a GPU.

    python -m mdeical_image_segmentation_tpu_torch.cli.serve \
        --unet2d name=vessel,path=/path/to/saved_bundle,resolution=256 \
        [--unet2d name=breast,path=...] [--port 6076] [--device cuda]

Each ``--unet2d`` adds a 2D bundle saved by either package's
``UNetModel.save_pretrained``; the first becomes the default.
``--exported name=...,path=...[,threshold=0.5]`` adds an artifact of
``cli.export`` (traced for the same ``--device``); ``--sam name=...,
path=...`` a promptable bundle of ``models.sam.save_sam``.
``quantize=int8`` serves it through the W8A8 conv path, calibrated on its
first ``calib_batches`` (default 1) request batches.  ``--demo``
starts with a small UNet initialized from a fixed seed (for smoke-testing
the API without trained weights).  ``--device`` defaults to ``cuda``; asking
for CUDA on a machine without it is an error, never a CPU run.
"""

import argparse
import sys


def _parse_bool(key: str, value: str) -> bool:
    """Strict truthy/falsy parse — a typo like tta=mirror must not silently
    disable the option the user asked for."""
    v = value.lower()
    if v in ("1", "true", "yes", "on", "mirror", "mirror-hw"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise SystemExit(f"--unet2d {key}={value!r}: expected a boolean "
                     "(1/0, true/false, yes/no, on/off, mirror, mirror-hw)")


def main(argv=None):
    parser = argparse.ArgumentParser(description="tpuseg serving API (PyTorch)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6076)
    parser.add_argument("--output_dir", default=None,
                        help="where 'path' mode writes masks "
                             "(default: <tmpdir>/tpuseg_masks)")
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--max_wait_ms", type=float, default=5.0)
    parser.add_argument(
        "--unet2d", action="append", default=[],
        help="name=<model name>,path=<save_pretrained dir>[,resolution=512]"
             "[,quantize=int8][,calib_batches=1][,tta=1]"
    )
    parser.add_argument(
        "--exported", action="append", default=[],
        help="name=<model name>,path=<cli.export artifact dir>"
             "[,threshold=0.5] — serve an exported artifact (no model code)"
    )
    parser.add_argument(
        "--sam", action="append", default=[],
        help="name=<model name>,path=<save_sam dir> (promptable segmentation)"
    )
    parser.add_argument("--demo", action="store_true",
                        help="register an untrained demo model")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default: cuda)")
    args = parser.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available "
                         "(pass --device cpu to serve on the CPU)")

    from mdeical_image_segmentation_tpu_torch.serve import ModelRegistry, serve

    registry = ModelRegistry()
    for spec in args.unet2d:
        kv = dict(item.split("=", 1) for item in spec.split(","))
        registry.register_unet2d(
            kv["name"], kv["path"], resolution=int(kv.get("resolution", 512)),
            quantize=kv.get("quantize"),
            calib_batches=int(kv.get("calib_batches", 1)),
            tta=_parse_bool("tta", kv.get("tta", "0")),
            device=device, max_batch=args.max_batch,
        )
    for spec in args.exported:
        kv = dict(item.split("=", 1) for item in spec.split(","))
        registry.register_exported(
            kv["name"], kv["path"],
            threshold=float(kv.get("threshold", 0.5)),
            device=device, max_batch=args.max_batch,
        )
    for spec in args.sam:
        kv = dict(item.split("=", 1) for item in spec.split(","))
        registry.register_sam(kv["name"], kv["path"], device=device,
                              max_batch=args.max_batch)

    if args.demo or not registry.names():
        import tempfile

        from mdeical_image_segmentation_tpu_torch.models import (
            UNetConfig,
            UNetModel,
        )

        # built on the CPU only to be saved; the registry loads it on device
        model = UNetModel(UNetConfig(in_channels=1, out_channels=1,
                                     unet_type="UNet", base_features=8),
                          device="cpu",
                          generator=torch.Generator().manual_seed(0))
        demo_dir = tempfile.mkdtemp(prefix="tpuseg_demo_")
        model.save_pretrained(demo_dir)
        registry.register_unet2d("demo", demo_dir, resolution=256,
                                 device=device, max_batch=args.max_batch)

    serve(registry, host=args.host, port=args.port,
          output_dir=args.output_dir, max_batch=args.max_batch,
          max_wait_ms=args.max_wait_ms)


if __name__ == "__main__":
    sys.exit(main())
