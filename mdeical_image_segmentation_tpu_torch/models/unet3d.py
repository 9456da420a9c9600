"""3D U-Net family, channels-last (the JAX package's ``models/unet3d.py``):
``UNet3D``, ``ResidualUNet3D``, ``ResidualUNetSE3D``, ``UNet2D`` and
``ResidualUNet2D``, the name registry and ``get_model``.

``AbstractUNet``: f_maps int → ×2 progression per level, an encoder stack
whose features are kept in reverse as skips, the decoders zipped with them,
and a 1x1(x1) final conv.  As in the JAX package (and its reference), the
final sigmoid/softmax is built but not applied: ``forward`` returns fp32
logits and ``final_activation()`` gives the activation for the predictor,
trainer or server to apply.  A model starts in eval mode (the JAX package's
``train=False`` default); ``model.train()`` turns its dropout on and its
BatchNorm to batch statistics.

``dtype`` (None, float32 or bfloat16, also as the strings a config holds):
bfloat16 keeps float32 parameters and computes in bf16 (``blocks3d.py``);
the final conv's output is cast to float32.  ``remat`` with
``remat_policy`` (None, 'save_convs', 'save_convs_norms', 'everything')
rematerializes each Encoder and Decoder as the JAX package's ``nn.remat``
does (``ops/remat.py`` maps the policies); unknown policies raise.  The 2D
members (``is3d`` False) take (N, H, W, C) and never take the fused path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..configs.registry import Registry
from ..ops.remat import checkpoint_block, resolve_policy
from .blocks3d import Decoder, Encoder, reset_tree
from .layers2d import TorchConv

MODELS_3D = Registry("model")


def number_of_features_per_level(init_channel_number: int,
                                 num_levels: int) -> List[int]:
    return [init_channel_number * 2**k for k in range(num_levels)]


def compute_dtype(dtype: Any) -> Optional[torch.dtype]:
    """A config's ``dtype`` (None, a torch dtype, or a name such as
    'bfloat16' or 'jnp.bfloat16') → None (compute in the input's dtype:
    float32) or ``torch.bfloat16``; other dtypes raise."""
    if dtype is None:
        return None
    name = str(dtype).split(".")[-1]
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"dtype {dtype!r}: the 3D models compute in float32 "
                     "or bfloat16")


class AbstractUNet(nn.Module):
    """Base encoder/decoder U-Net."""

    basic_module = "DoubleConv"
    default_num_levels = 4
    is3d = True

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 final_sigmoid: bool = True,
                 f_maps: Union[int, Sequence[int]] = 64,
                 layer_order: str = "gcr", num_groups: int = 8,
                 num_levels: Optional[int] = None,
                 is_segmentation: bool = True,
                 conv_kernel_size: Union[int, Sequence[int]] = 3,
                 pool_kernel_size: Union[int, Sequence[int]] = 2,
                 conv_padding: Union[int, Sequence[int]] = 1,
                 conv_upscale: int = 2, upsample: Optional[str] = "default",
                 dropout_prob: Union[float, Sequence[float]] = 0.1,
                 dtype: Any = None, remat: bool = False,
                 remat_policy: Optional[str] = None, *, device=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.remat = bool(remat)
        self.remat_policy = resolve_policy(remat_policy)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.final_sigmoid = final_sigmoid
        self.is_segmentation = is_segmentation
        self.num_levels = (self.default_num_levels if num_levels is None
                           else num_levels)
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, self.num_levels)
        f_maps = list(f_maps)
        if len(f_maps) < 2:
            raise ValueError("Required at least 2 levels in the U-Net")
        self.f_maps = f_maps
        common = dict(conv_layer_order=layer_order, num_groups=num_groups,
                      padding=conv_padding, dropout_prob=dropout_prob,
                      is3d=self.is3d, dtype=self.dtype, device=device)
        c = in_channels
        for i, feats in enumerate(f_maps):
            setattr(self, f"encoder{i}", Encoder(
                c, feats, conv_kernel_size, apply_pooling=i > 0,
                pool_kernel_size=pool_kernel_size,
                basic_module=self.basic_module, upscale=conv_upscale,
                **common))
            c = feats
        rev = list(reversed(f_maps))
        for i in range(len(f_maps) - 1):
            setattr(self, f"decoder{i}", Decoder(
                c, rev[i + 1], rev[i + 1], conv_kernel_size,
                basic_module=self.basic_module, upsample=upsample, **common))
            c = rev[i + 1]
        self.final_conv = TorchConv(c, out_channels,
                                    (1,) * (3 if self.is3d else 2),
                                    dtype=self.dtype, device=device)
        self.train(False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default conv init for every conv (GroupNorm to ones and
        zeros), drawn in registration order from ``generator``."""
        reset_tree(self, generator)

    def _block(self, block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        """An Encoder or Decoder, recomputed in the backward under remat
        with the None policy while autograd records."""
        if (self.remat and self.remat_policy is None
                and torch.is_grad_enabled()):
            return checkpoint_block(block, *args)
        return block(*args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(len(self.f_maps)):
            x = self._block(getattr(self, f"encoder{i}"), x)
            skips.insert(0, x)
        for i, skip in enumerate(skips[1:]):
            x = self._block(getattr(self, f"decoder{i}"), skip, x)
        return self.final_conv(x).float()

    def final_activation(self) -> Optional[Callable[[torch.Tensor],
                                                    torch.Tensor]]:
        """Sigmoid or channel softmax for segmentation, None otherwise."""
        if not self.is_segmentation:
            return None
        if self.final_sigmoid:
            return torch.sigmoid
        return lambda t: torch.softmax(t, dim=-1)


@MODELS_3D.register("UNet3D")
class UNet3D(AbstractUNet):
    """3D U-Net: DoubleConv blocks, nearest upsampling, concat joins."""

    basic_module = "DoubleConv"
    default_num_levels = 4


@MODELS_3D.register("ResidualUNet3D")
class ResidualUNet3D(AbstractUNet):
    """Residual 3D U-Net: ResNetBlocks, deconv upsampling, summation joins,
    5 levels."""

    basic_module = "ResNetBlock"
    default_num_levels = 5


@MODELS_3D.register("ResidualUNetSE3D")
class ResidualUNetSE3D(AbstractUNet):
    """Residual 3D U-Net with squeeze-excitation (scSE) after each
    ResNetBlock, 5 levels."""

    basic_module = "ResNetBlockSE"
    default_num_levels = 5


@MODELS_3D.register("UNet2D")
class UNet2D(AbstractUNet):
    """The 2D U-Net through the same blocks: (N, H, W, C)."""

    basic_module = "DoubleConv"
    default_num_levels = 4
    is3d = False


@MODELS_3D.register("ResidualUNet2D")
class ResidualUNet2D(AbstractUNet):
    """The 2D residual U-Net, 5 levels."""

    basic_module = "ResNetBlock"
    default_num_levels = 5
    is3d = False


_MODEL_FIELDS = {
    "in_channels", "out_channels", "final_sigmoid", "f_maps", "layer_order",
    "num_groups", "num_levels", "is_segmentation", "conv_kernel_size",
    "pool_kernel_size", "conv_padding", "conv_upscale", "upsample",
    "dropout_prob", "dtype", "remat", "remat_policy",
}


def get_model(model_config: Mapping[str, Any], *, device=None,
              generator: Optional[torch.Generator] = None) -> AbstractUNet:
    """Name-dispatched model construction from a config's ``model`` section
    (keys that are no model field, such as ``model_path``, are dropped).
    Parameters are drawn from ``generator`` when one is given, else left
    uninitialized for a ``load_state_dict``."""
    cfg: Dict[str, Any] = dict(model_config)
    cls = MODELS_3D.get(cfg.pop("name"))
    kwargs = {k: v for k, v in cfg.items() if k in _MODEL_FIELDS}
    model = cls(**kwargs, device=device)
    if generator is not None:
        model.reset_parameters(generator)
    return model
