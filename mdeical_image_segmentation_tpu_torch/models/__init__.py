"""Models of the port (the JAX package's ``models``: the classic UNet, the
UNet-3+ family, the 3D UNet family with its 2D members and its bundle
wrapper, and SAM-Med2D)."""

from .blocks3d import (
    DoubleConv,
    Decoder,
    Encoder,
    ResNetBlock,
    ResNetBlockSE,
    SingleConv,
    TransposeConvUpsampling,
)
from .layers2d import (
    ConvBNReLU,
    DoubleConvolution,
    TorchBatchNorm,
    TorchConv,
    TorchConvTranspose,
    UNetConv2,
    UNetUp,
    UNetUpOrigin,
    UpSample,
    crop_and_concat,
)
from .unet2d import UNet, UNet3Plus, UNet3PlusDeepSup, UNet3PlusDeepSupCGM
from .unet3d import (
    MODELS_3D,
    AbstractUNet,
    ResidualUNet2D,
    ResidualUNet3D,
    ResidualUNetSE3D,
    UNet2D,
    UNet3D,
    get_model,
)
from .wrappers import UNET_TYPES, SegOutput, UNetConfig, UNetModel
from .wrappers3d import UNet3DConfig, UNet3DForMedicalSegmentation
from .sam import ImageEncoderViT, MaskDecoder, PromptEncoder, SAMMed2D, sam_loss

__all__ = [
    "AbstractUNet",
    "ConvBNReLU",
    "Decoder",
    "DoubleConv",
    "DoubleConvolution",
    "Encoder",
    "MODELS_3D",
    "ResNetBlock",
    "ResNetBlockSE",
    "ResidualUNet2D",
    "ResidualUNet3D",
    "ResidualUNetSE3D",
    "SegOutput",
    "SingleConv",
    "TorchBatchNorm",
    "TorchConv",
    "TorchConvTranspose",
    "TransposeConvUpsampling",
    "UNET_TYPES",
    "UNet",
    "UNet2D",
    "UNet3D",
    "UNet3Plus",
    "UNet3PlusDeepSup",
    "UNet3PlusDeepSupCGM",
    "UNetConfig",
    "UNetConv2",
    "UNetModel",
    "UNetUp",
    "UNetUpOrigin",
    "UpSample",
    "crop_and_concat",
    "get_model",
    "UNet3DConfig",
    "UNet3DForMedicalSegmentation",
    "ImageEncoderViT",
    "MaskDecoder",
    "PromptEncoder",
    "SAMMed2D",
    "sam_loss",
]
