"""2D layers of the classic UNet, channels-last (the JAX package's
``models/layers2d.py``).

Activations are NHWC at every module boundary.  Parameters are stored the
PyTorch way (``weight`` OIHW, ConvTranspose ``weight`` (I, O, kh, kw)) under
module names that mirror the flax tree, so ``utils/param_bridge.py`` maps one
onto the other leaf for leaf.  Modules build their parameters empty on a
given device; ``reset_parameters(generator)`` draws PyTorch's default conv
init from an explicit generator.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_conv import fused_double2d
from ..ops.image import center_crop


def _torch_default_init_(weight: nn.Parameter, bias: nn.Parameter,
                         fan_in: int, generator: torch.Generator) -> None:
    """``nn.Conv2d.reset_parameters``: kaiming-uniform(a=sqrt(5)) weight,
    U(±1/sqrt(fan_in)) bias."""
    with torch.no_grad():
        nn.init.kaiming_uniform_(weight, a=math.sqrt(5), generator=generator)
        bound = 1.0 / math.sqrt(fan_in)
        nn.init.uniform_(bias, -bound, bound, generator=generator)


class TorchConv(nn.Module):
    """Stride-1 NHWC conv with 'SAME' padding (odd kernels)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (3, 3), *, device=None):
        super().__init__()
        ks = tuple(kernel_size)
        if any(k % 2 == 0 for k in ks):
            raise ValueError(f"TorchConv takes odd kernels, got {ks}")
        self.padding = tuple(k // 2 for k in ks)
        self.weight = nn.Parameter(
            torch.empty((features, in_features, *ks), device=device))
        self.bias = nn.Parameter(torch.empty((features,), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _torch_default_init_(self.weight, self.bias,
                             self.weight[0].numel(), generator)

    def hwio(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel HWIO, bias) — the JAX layout the fused kernel takes."""
        return self.weight.permute(2, 3, 1, 0).contiguous(), self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)


class TorchConvTranspose(nn.Module):
    """NHWC ``nn.ConvTranspose2d(k, s, padding=0)``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (2, 2),
                 strides: Sequence[int] = (2, 2), *, device=None):
        super().__init__()
        self.strides = tuple(strides)
        self.weight = nn.Parameter(torch.empty(
            (in_features, features, *tuple(kernel_size)), device=device))
        self.bias = nn.Parameter(torch.empty((features,), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch counts fan_in of (I, O, kh, kw) over dim 1: O * kh * kw
        _torch_default_init_(self.weight, self.bias,
                             self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                               stride=self.strides)
        return y.permute(0, 2, 3, 1)


class DoubleConvolution(nn.Module):
    """2 × (conv3x3 + ReLU) as one ``fused_double2d`` call: the CUDA kernel
    on a CUDA tensor, the plain two-conv version on a CPU tensor."""

    def __init__(self, in_features: int, features: int, *, device=None):
        super().__init__()
        self.TorchConv_0 = TorchConv(in_features, features, device=device)
        self.TorchConv_1 = TorchConv(features, features, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.TorchConv_0.reset_parameters(generator)
        self.TorchConv_1.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w1, b1 = self.TorchConv_0.hwio()
        w2, b2 = self.TorchConv_1.hwio()
        y, _ = fused_double2d(x.contiguous(), w1, b1, w2, b2, with_z=False)
        return y


class UpSample(nn.Module):
    """ConvTranspose k2 s2 (the classic UNet's expansive path)."""

    def __init__(self, in_features: int, features: int, *, device=None):
        super().__init__()
        self.TorchConvTranspose_0 = TorchConvTranspose(
            in_features, features, (2, 2), (2, 2), device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.TorchConvTranspose_0.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.TorchConvTranspose_0(x)


def crop_and_concat(x: torch.Tensor, contracting_x: torch.Tensor,
                    ) -> torch.Tensor:
    """Center-crop the skip to x's spatial size, concat on channels."""
    skip = center_crop(contracting_x, x.shape[1:-1])
    return torch.cat([x, skip], dim=-1)

