"""Squeeze-and-excitation gates, channels-last and of any rank (the JAX
package's ``models/se3d.py``).

- ``ChannelSELayer`` (cSE): the spatial mean per (sample, channel), a dense
  bottleneck (``Dense_0``, ReLU, ``Dense_1``), a sigmoid gate per channel;
- ``SpatialSELayer`` (sSE): a 1x...x1 conv to one channel (``TorchConv_0``),
  a sigmoid gate per position;
- ``ChannelSpatialSELayer`` (scSE): the element-wise max of the two.

The gates are element-wise PyTorch ops, as they are XLA ops in the JAX
package.  ``Dense`` keeps flax's layout names and init (lecun-normal kernel,
zero bias); its weight is stored the torch way, ``(out, in)``, and
``utils/param_bridge.py`` transposes it to flax's ``(in, out)`` kernel.
``dtype`` set: inputs, weights and biases are cast to it at use, as flax's
``promote_dtype`` does; the parameters stay float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops import initializers as tinit
from ..parallel import tensor as tp
from .layers2d import TorchConv


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` over the last axis."""

    def __init__(self, in_features: int, features: int, *,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty((features, in_features), device=device))
        self.bias = nn.Parameter(torch.empty((features,), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            tinit.lecun_normal(self.weight, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp.column_parallel(self, self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return torch.nn.functional.linear(
            x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


class ChannelSELayer(nn.Module):
    """Channel squeeze-excitation: x · sigmoid(Dense_1(relu(Dense_0(mean
    over space))))."""

    def __init__(self, channels: int, reduction_ratio: int = 2, *,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        reduced = max(channels // reduction_ratio, 1)
        self.Dense_0 = Dense(channels, reduced, dtype=dtype, device=device)
        self.Dense_1 = Dense(reduced, channels, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.Dense_0.reset_parameters(generator)
        self.Dense_1.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.mean(dim=tuple(range(1, x.ndim - 1)))  # (N, C)
        gate = torch.sigmoid(self.Dense_1(torch.relu(self.Dense_0(squeeze))))
        return x * gate.reshape(gate.shape[:1] + (1,) * (x.ndim - 2)
                                + gate.shape[-1:])


class SpatialSELayer(nn.Module):
    """Spatial squeeze-excitation: x · sigmoid(1x...x1 conv to 1 channel)."""

    def __init__(self, channels: int, nsp: int = 3, *,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.TorchConv_0 = TorchConv(channels, 1, (1,) * nsp, dtype=dtype,
                                     device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.TorchConv_0.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.TorchConv_0(x))


class ChannelSpatialSELayer(nn.Module):
    """Concurrent cSE and sSE merged by the element-wise max (scSE)."""

    def __init__(self, channels: int, reduction_ratio: int = 2,
                 nsp: int = 3, *, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.ChannelSELayer_0 = ChannelSELayer(
            channels, reduction_ratio, dtype=dtype, device=device)
        self.SpatialSELayer_0 = SpatialSELayer(channels, nsp, dtype=dtype,
                                               device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ChannelSELayer_0.reset_parameters(generator)
        self.SpatialSELayer_0.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.maximum(self.ChannelSELayer_0(x),
                             self.SpatialSELayer_0(x))


def se_module(name: str, channels: int, nsp: int, *,
              dtype: Optional[torch.dtype] = None, device=None) -> nn.Module:
    """The JAX package's ``SE_MODULES[name]``: 'cse' and 'scse' with
    reduction ratio 1, 'sse'."""
    if name == "cse":
        return ChannelSELayer(channels, 1, dtype=dtype, device=device)
    if name == "sse":
        return SpatialSELayer(channels, nsp, dtype=dtype, device=device)
    if name == "scse":
        return ChannelSpatialSELayer(channels, 1, nsp, dtype=dtype,
                                     device=device)
    raise ValueError(f"se_module {name!r}: 'cse', 'sse' or 'scse'")
