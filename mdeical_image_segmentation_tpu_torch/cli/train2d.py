"""2D training CLI (the JAX package's ``cli/train2d.py``): the same 30
flags and defaults, plus ``--device``.

    python -m mdeical_image_segmentation_tpu_torch.cli.train2d \\
        --synthetic 8 --unet_type UNet --resolution 64 --base_features 8 \\
        --in_channels 1 --max_steps 4 --device cpu

Argparse → a timestamped output directory → the DRIVE or BUSI datasets (or
``--synthetic N`` slices) → ``TrainingArguments`` → ``UNetConfig`` /
``UNetModel`` → ``Trainer`` → train, evaluate, and a final bundle under
``<run>/final``.  It trains on the card unless ``--device cpu`` is given.
The default ``--unet_type UNet_3Plus`` trains the reference's 512² config;
``--remat auto`` turns remat on for the UNet-3+ family at >= 384 px, with
``--remat_policy`` (default ``save_convs``, ``ops/remat.py``).  float32
runs in full float32 (TF32 off).
"""

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tpuseg 2D segmentation training "
                                "(PyTorch port)")
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--dataset", type=str, default="DRIVE",
                   choices=["DRIVE", "BUSI"])
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic samples instead of --data_path")
    p.add_argument("--eval_strategy", type=str, default="steps",
                   choices=["no", "steps", "epoch"])
    p.add_argument("--eval_steps", type=int, default=100)
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--num_train_epochs", type=float, default=5000)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--per_device_train_batch_size", type=int, default=5)
    p.add_argument("--per_device_eval_batch_size", type=int, default=5)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--save_total_limit", type=int, default=5)
    p.add_argument("--warmup_ratio", type=float, default=0.001)
    p.add_argument("--learning_rate", type=float, default=0.005)
    p.add_argument("--weight_decay", type=float, default=0.001)
    p.add_argument("--max_grad_norm", type=float, default=1.0,
                   help="global grad-norm clip (HF default 1.0; 0 disables)")
    p.add_argument("--metric_for_best_model", type=str, default="iou")
    p.add_argument("--in_channels", type=int, default=3)
    p.add_argument("--out_channels", type=int, default=1)
    p.add_argument("--unet_type", type=str, default="UNet_3Plus",
                   choices=["UNet", "UNet_3Plus", "UNet_3Plus_DeepSup",
                            "UNet_3Plus_DeepSup_CGM"])
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--base_features", type=int, default=64)
    p.add_argument("--remat", choices=["auto", "on", "off"], default="auto",
                   help="rematerialize blocks; 'auto' turns it on for the "
                   "UNet-3+ family at >= 384 px")
    p.add_argument("--remat_policy",
                   choices=["none", "save_convs", "save_convs_norms",
                            "everything"],
                   default="save_convs",
                   help="checkpoint policy when remat is on")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--dataset_on_device", action="store_true",
                   help="keep the train set on the device; sample batches "
                   "there")
    p.add_argument("--stream", action="store_true",
                   help="decode PNGs at every access instead of caching "
                   "them in RAM")
    p.add_argument("--dataloader_num_workers", type=int, default=0,
                   help="decode threads per loader (pair with --stream)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the card; an error without one) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from ..data import BUSIDataset, DRIVEDataset, SyntheticSliceDataset
    from ..logging_utils import get_logger
    from ..models import UNetConfig, UNetModel
    from ..train import BestIoUCallback, Trainer, TrainingArguments
    from . import pin_fp32_precision

    pin_fp32_precision(get_logger("train2d"))

    ts = time.strftime("%Y-%m-%d-%H-%M-%S")
    output_dir = os.path.join(args.output_dir, ts, args.unet_type)
    os.makedirs(output_dir, exist_ok=True)

    if args.synthetic:
        train_ds = SyntheticSliceDataset(
            n_samples=args.synthetic, resolution=args.resolution,
            channels=args.in_channels)
        eval_ds = SyntheticSliceDataset(
            n_samples=max(args.synthetic // 5, 4),
            resolution=args.resolution, channels=args.in_channels, seed=7)
    else:
        if not args.data_path:
            raise SystemExit("--data_path or --synthetic required")
        ds_cls = DRIVEDataset if args.dataset == "DRIVE" else BUSIDataset
        train_ds = ds_cls(args.data_path, mode="train",
                          resolution=args.resolution, cache=not args.stream)
        eval_ds = ds_cls(args.data_path, mode="eval",
                         resolution=args.resolution, cache=not args.stream)
        if train_ds.num_channels != args.in_channels:
            raise SystemExit(
                f"--in_channels {args.in_channels} does not match "
                f"{args.dataset}'s {train_ds.num_channels} image channels — "
                f"pass --in_channels {train_ds.num_channels}")

    if args.remat == "auto":
        use_remat = (args.unet_type.startswith("UNet_3Plus")
                     and args.resolution >= 384)
    else:
        use_remat = args.remat == "on"
    if use_remat:
        print(f"remat enabled ({args.unet_type} @ {args.resolution}px)")

    config = UNetConfig(
        in_channels=args.in_channels, out_channels=args.out_channels,
        unet_type=args.unet_type, base_features=args.base_features,
        remat=use_remat,
        remat_policy=None if args.remat_policy == "none" else args.remat_policy,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    model = UNetModel(config, device=args.device,
                      generator=torch.Generator().manual_seed(args.seed))

    targs = TrainingArguments(
        output_dir=output_dir,
        dataloader_num_workers=args.dataloader_num_workers,
        eval_strategy=args.eval_strategy, eval_steps=args.eval_steps,
        logging_steps=args.logging_steps,
        num_train_epochs=args.num_train_epochs, max_steps=args.max_steps,
        per_device_train_batch_size=args.per_device_train_batch_size,
        per_device_eval_batch_size=args.per_device_eval_batch_size,
        save_steps=args.save_steps, save_total_limit=args.save_total_limit,
        warmup_ratio=args.warmup_ratio, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        metric_for_best_model=args.metric_for_best_model, seed=args.seed,
        bf16=args.bf16, dataset_on_device=args.dataset_on_device,
        plot_eval=True)
    trainer = Trainer(
        model, targs, train_ds, eval_ds,
        callbacks=[BestIoUCallback(f"eval_{args.metric_for_best_model}")],
        device=args.device)
    trainer.train()
    print(trainer.evaluate())
    # a finished run is servable as it is (register_unet2d)
    bundle_dir = os.path.join(output_dir, "final")
    trainer.save_model(bundle_dir)
    print(f"saved model bundle to {bundle_dir}")
    return output_dir


if __name__ == "__main__":
    main()
