"""tpuseg on PyTorch and CUDA — the port of ``mdeical_image_segmentation_tpu``.

The JAX package beside this one is the reference; this package keeps its
module paths and names, so each part has an obvious counterpart there.  It
imports ``torch`` and numpy, never jax, flax, optax, msgpack, PIL, h5py,
yaml, sklearn or matplotlib.

Covered so far:

- the 2D classic-UNet serving path (``cli.serve`` → ``serve.app`` →
  ``models.wrappers.UNetModel`` → ``models.unet2d.UNet`` →
  ``models.layers2d.DoubleConvolution`` → ``ops.fused_conv.fused_double2d``,
  a hand-written CUDA kernel in ``csrc/double_conv2d.cu``);
- 3D sliding-window inference (``infer.predictor.StandardPredictor`` →
  ``models.unet3d`` UNet3D / ResidualUNet3D → ``models.blocks3d`` →
  the GroupNorm kernels of ``ops.norm`` and the fused GroupNorm-apply conv
  of ``ops.fused_conv.fused_conv3d``, then the overlap-add of
  ``ops.overlap``; CUDA in ``csrc/group_norm.cu``, ``csrc/gcr_conv3d.cu``
  and ``csrc/overlap_add.cu``), checkpoints (``train.checkpoint``) and 3D
  slice serving (``serve.app.ModelRegistry.register_unet3d``);
- 3D 'gcr' training (``train.trainer3d.UNetTrainer``);
- 2D classic-UNet training (``cli.train2d`` → ``train.trainer2d.Trainer``
  → ``UNetModel`` with its loss → ``ops.fused_conv.double_conv2d``, kernel
  1's forward under an autograd Function), with the PNG datasets
  (``data.png2d``, ``data.collate``), on-device augmentation
  (``transforms.device2d``) and the 2D metrics (``metrics.metrics2d``);
- the UNet-3+ family (``models.unet2d`` UNet3Plus, UNet3PlusDeepSup,
  UNet3PlusDeepSupCGM) trained and served through the same entry points,
  with BatchNorm (``ops.batchnorm``), the hybrid F1 + MS-SSIM + IoU loss
  (``ops.msssim``, ``losses.losses2d``), remat (``ops.remat``) and the
  initializers (``ops.initializers``), on cuDNN convs and PyTorch ops.
- the config-driven 3D pipeline (``cli.train3d`` → ``configs.config`` →
  ``train.trainer3d.create_trainer`` → ``data.loaders.get_train_loaders``
  → ``data.hdf5`` → ``transforms.volume``; ``cli.predict3d`` →
  ``data.loaders.get_test_loaders`` → ``StandardPredictor.__call__``), on
  the port's own YAML reader and writer (``utils.yaml_io``) and HDF5 codec
  (``utils.hdf5``);
- the rest of the 3D family: bf16 compute, remat of the Encoders and
  Decoders (``ops.remat``), ``ResidualUNetSE3D`` (``models.se3d``), the
  BatchNorm orders, ``UNet2D`` and ``ResidualUNet2D``, and device-resident
  train volumes (``data.device_cache``, ``loaders.device_cache: true``);
- int8 post-training quantization (``ops.quant``, ``csrc/int8_conv.cu``);
- exported artifacts (``export``, ``cli.export``: ``torch.export`` programs
  that reach kernels 1, 2, 3a and 3b as ``tpuseg::`` custom ops, served by
  ``ModelRegistry.register_exported``), the 3D bundle wrapper
  (``models.wrappers3d``) and SAM-Med2D promptable serving
  (``models.sam``, ``ModelRegistry.register_sam``).

Public functions keep the JAX layout: channels-last activations and
(*k, I, O) conv weights.
"""

__version__ = "0.1.0"

# Subpackages are imported lazily so that importing the package costs nothing
# and builds no kernel.
import importlib as _importlib

_SUBMODULES = (
    "cli",
    "configs",
    "data",
    "export",
    "infer",
    "losses",
    "metrics",
    "models",
    "ops",
    "serve",
    "train",
    "transforms",
    "utils",
)


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
