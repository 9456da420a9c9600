"""Config-driven 3D training (the JAX package's ``cli/train3d.py``).

    python -m mdeical_image_segmentation_tpu_torch.cli.train3d \\
        --config configs/unet3d_train.yml \\
        --loaders.train.file_paths "['/data/train']" \\
        --loaders.val.file_paths "['/data/val']" [--device cpu]

Loads the YAML config with its dotted overrides (``--a.b value`` or
``a.b=value``), builds the trainer (``train/trainer3d.create_trainer``: on
the card unless ``device: cpu``), snapshots the resolved config into the
checkpoint directory (the primary process of a multi-process run) and
trains, float32 in full float32 (TF32 off).  A ``parallel:`` section's
keys take overrides too, e.g. ``--parallel.spatial_halo 16
--parallel.spatial_cross_shard_norm true`` for spatially sharded
training over the processes of the group, ``--parallel.model_axis 2
--parallel.tensor_parallel true`` for channel tensor parallelism over a
model axis of 2, ``--parallel.zero1 true`` for the optimizer state
sharded over the data axis.
"""

import sys


def main(argv=None):
    from ..configs import copy_config, load_config
    from ..logging_utils import get_logger
    from ..parallel.distributed import is_primary
    from ..train import trainer3d
    from . import pin_fp32_precision

    config = load_config(argv if argv is not None else sys.argv[1:])
    pin_fp32_precision(get_logger("train3d"))
    trainer = trainer3d.create_trainer(config)
    if is_primary():
        copy_config(config, trainer.checkpoint_dir)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
