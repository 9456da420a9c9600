"""tpuseg on PyTorch and CUDA — the port of ``mdeical_image_segmentation_tpu``.

The JAX package beside this one is the reference; this package keeps its
module paths and names, so each part has an obvious counterpart there.  It
imports ``torch`` and numpy, never jax, flax, msgpack or PIL.

Covered so far: the 2D classic-UNet serving path (``cli.serve`` →
``serve.app`` → ``models.wrappers.UNetModel`` → ``models.unet2d.UNet`` →
``models.layers2d.DoubleConvolution`` → ``ops.fused_conv.fused_double2d``,
a hand-written CUDA kernel in ``csrc/double_conv2d.cu``).  Public functions
keep the JAX layout: NHWC activations and HWIO conv weights.
"""

__version__ = "0.1.0"

# Subpackages are imported lazily so that importing the package costs nothing
# and builds no kernel.
import importlib as _importlib

_SUBMODULES = (
    "cli",
    "data",
    "models",
    "ops",
    "serve",
    "utils",
)


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
