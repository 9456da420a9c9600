"""2D segmentation models, channels-last (the JAX package's
``models/unet2d.py``; the classic UNet so far)."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.image import max_pool2d
from .layers2d import DoubleConvolution, TorchConv, UpSample, crop_and_concat


class UNet(nn.Module):
    """Classic U-Net: four DoubleConv + max-pool levels down, a DoubleConv
    bottleneck, four ConvTranspose k2s2 + center-crop skip concat +
    DoubleConv levels up, and a 1x1 head.  ``base_features`` scales the
    channel progression (64 in the reference).

    Children are registered in the order flax creates them, under the same
    names (DoubleConvolution_0..8, UpSample_0..3, TorchConv_0), so the
    ``state_dict`` keys and order mirror the flax tree."""

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 base_features: int = 64, *, device=None):
        super().__init__()
        f = base_features
        downs = (f, 2 * f, 4 * f, 8 * f)
        self.levels = len(downs)
        c = in_channels
        for i, feats in enumerate(downs):
            setattr(self, f"DoubleConvolution_{i}",
                    DoubleConvolution(c, feats, device=device))
            c = feats
        self.DoubleConvolution_4 = DoubleConvolution(c, 16 * f, device=device)
        c = 16 * f
        for i, feats in enumerate(reversed(downs)):
            setattr(self, f"UpSample_{i}", UpSample(c, feats, device=device))
            setattr(self, f"DoubleConvolution_{5 + i}",
                    DoubleConvolution(2 * feats, feats, device=device))
            c = feats
        self.TorchConv_0 = TorchConv(c, out_channels, (1, 1), device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default conv init for every layer, drawn in
        registration order from ``generator``."""
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"DoubleConvolution_{i}")(x)
            skips.append(x)
            x = max_pool2d(x, 2)
        x = self.DoubleConvolution_4(x)
        for i in range(self.levels):
            x = getattr(self, f"UpSample_{i}")(x)
            x = crop_and_concat(x, skips.pop())
            x = getattr(self, f"DoubleConvolution_{5 + i}")(x)
        return self.TorchConv_0(x)
