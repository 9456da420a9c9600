"""Models of the port (the JAX package's ``models``; the classic UNet and
the 3D UNet family so far)."""

from .blocks3d import (
    DoubleConv,
    Decoder,
    Encoder,
    ResNetBlock,
    SingleConv,
    TransposeConvUpsampling,
)
from .layers2d import (
    DoubleConvolution,
    TorchConv,
    TorchConvTranspose,
    UpSample,
    crop_and_concat,
)
from .unet2d import UNet
from .unet3d import (
    MODELS_3D,
    AbstractUNet,
    ResidualUNet3D,
    UNet3D,
    get_model,
)
from .wrappers import SegOutput, UNetConfig, UNetModel

__all__ = [
    "AbstractUNet",
    "Decoder",
    "DoubleConv",
    "DoubleConvolution",
    "Encoder",
    "MODELS_3D",
    "ResNetBlock",
    "ResidualUNet3D",
    "SegOutput",
    "SingleConv",
    "TorchConv",
    "TorchConvTranspose",
    "TransposeConvUpsampling",
    "UNet",
    "UNet3D",
    "UNetConfig",
    "UNetModel",
    "UpSample",
    "crop_and_concat",
    "get_model",
]
