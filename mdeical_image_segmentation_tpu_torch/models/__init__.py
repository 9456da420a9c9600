"""Models of the port (the JAX package's ``models``; the classic UNet so
far)."""

from .layers2d import (
    DoubleConvolution,
    TorchConv,
    TorchConvTranspose,
    UpSample,
    crop_and_concat,
)
from .unet2d import UNet
from .wrappers import SegOutput, UNetConfig, UNetModel

__all__ = [
    "DoubleConvolution",
    "SegOutput",
    "TorchConv",
    "TorchConvTranspose",
    "UNet",
    "UNetConfig",
    "UNetModel",
    "UpSample",
    "crop_and_concat",
]
