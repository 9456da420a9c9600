"""tpuseg on PyTorch and CUDA — the port of ``mdeical_image_segmentation_tpu``.

The JAX package beside this one is the reference; this package keeps its
module paths and names, so each part has an obvious counterpart there.  It
imports ``torch`` and numpy, never jax, flax, msgpack or PIL.

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
  slice serving (``serve.app.ModelRegistry.register_unet3d``).

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
    "infer",
    "models",
    "ops",
    "serve",
    "train",
    "utils",
)


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
