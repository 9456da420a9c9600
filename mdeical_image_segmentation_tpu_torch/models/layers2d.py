"""Layers of the classic UNet, channels-last (the JAX package's
``models/layers2d.py``); ``TorchConv`` and ``TorchConvTranspose`` also take
3D kernels for the 3D UNet family.

Activations are channels-last at every module boundary.  Parameters are
stored the PyTorch way (``weight`` (O, I, *k), ConvTranspose ``weight``
(I, O, *k)) under module names that mirror the flax tree, so
``utils/param_bridge.py`` maps one onto the other leaf for leaf.  Modules
build their parameters empty on a given device; ``reset_parameters(
generator)`` draws PyTorch's default conv init from an explicit generator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_conv import double_conv2d, fused_double2d
from ..ops.image import center_crop


def _torch_default_init_(weight: nn.Parameter, bias: Optional[nn.Parameter],
                         fan_in: int, generator: torch.Generator) -> None:
    """``nn.Conv2d.reset_parameters``: kaiming-uniform(a=sqrt(5)) weight,
    U(±1/sqrt(fan_in)) bias."""
    with torch.no_grad():
        nn.init.kaiming_uniform_(weight, a=math.sqrt(5), generator=generator)
        if bias is not None:
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(bias, -bound, bound, generator=generator)


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, *range(2, x.ndim), 1)


class TorchConv(nn.Module):
    """Stride-1 channels-last conv (2D or 3D by ``len(kernel_size)``) with
    'SAME' padding (odd kernels), bias optional."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (3, 3), *,
                 use_bias: bool = True, device=None):
        super().__init__()
        ks = tuple(kernel_size)
        if len(ks) not in (2, 3) or any(k % 2 == 0 for k in ks):
            raise ValueError(f"TorchConv takes odd 2D or 3D kernels, got {ks}")
        self.padding = tuple(k // 2 for k in ks)
        self._conv = F.conv2d if len(ks) == 2 else F.conv3d
        self.weight = nn.Parameter(
            torch.empty((features, in_features, *ks), device=device))
        self.bias = (nn.Parameter(torch.empty((features,), device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _torch_default_init_(self.weight, self.bias,
                             self.weight[0].numel(), generator)

    def hwio(self, dtype: Optional[torch.dtype] = None,
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(kernel in the JAX layout (*k, I, O), bias), contiguous and cast
        to ``dtype`` (the parameters' own by default) — what the fused
        kernels take."""
        w, b = self.weight, self.bias
        dtype = dtype or w.dtype
        w = w.permute(*range(2, w.ndim), 1, 0).contiguous().to(dtype)
        return w, (None if b is None else b.to(dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = self._conv(_channels_first(x), self.weight.to(x.dtype), bias,
                       padding=self.padding)
        return _channels_last(y)


class TorchConvTranspose(nn.Module):
    """Channels-last ``nn.ConvTranspose{2,3}d(k, s, padding)`` (2D or 3D by
    ``len(kernel_size)``), bias optional."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (2, 2),
                 strides: Sequence[int] = (2, 2), *, padding: int = 0,
                 use_bias: bool = True, device=None):
        super().__init__()
        ks = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self._conv = {2: F.conv_transpose2d, 3: F.conv_transpose3d}[len(ks)]
        self.weight = nn.Parameter(torch.empty(
            (in_features, features, *ks), device=device))
        self.bias = (nn.Parameter(torch.empty((features,), device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch counts fan_in of (I, O, *k) over dim 1: O * prod(k)
        _torch_default_init_(self.weight, self.bias,
                             self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = self._conv(_channels_first(x), self.weight.to(x.dtype), bias,
                       stride=self.strides, padding=self.padding)
        return _channels_last(y)


class DoubleConvolution(nn.Module):
    """2 × (conv3x3 + ReLU) as one call of kernel 1: the CUDA kernel on a
    CUDA tensor, the plain two-conv version on a CPU tensor.  The weights
    are cast to x's dtype at use (fp32 master weights under bf16 compute).
    While autograd records, the call is ``double_conv2d`` (z kept for the
    backward); otherwise ``fused_double2d`` without z (serving)."""

    def __init__(self, in_features: int, features: int, *, device=None):
        super().__init__()
        self.TorchConv_0 = TorchConv(in_features, features, device=device)
        self.TorchConv_1 = TorchConv(features, features, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.TorchConv_0.reset_parameters(generator)
        self.TorchConv_1.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w1, b1 = self.TorchConv_0.hwio(x.dtype)
        w2, b2 = self.TorchConv_1.hwio(x.dtype)
        x = x.contiguous()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, w1, b1, w2, b2)):
            return double_conv2d(x, w1, b1, w2, b2)
        y, _ = fused_double2d(x, w1, b1, w2, b2, with_z=False)
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

