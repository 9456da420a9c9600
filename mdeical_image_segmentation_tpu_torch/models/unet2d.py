"""2D segmentation models, channels-last (the JAX package's
``models/unet2d.py``): the classic UNet and the UNet-3+ family.

- ``UNet`` — four DoubleConv + max-pool levels, ConvTranspose k2s2 up,
  center-crop skip concat, 1×1 head.
- ``UNet3Plus`` — a 5-level encoder with full-scale skips: each decoder
  stage fuses all 5 scales (shallower encoders max-pooled with ceil_mode,
  the same-scale encoder, deeper stages upsampled bilinearly), each through
  conv3×3 + BN + ReLU to 64 channels, concatenated to 320 and fused; a 3×3
  head on hd1.
- ``UNet3PlusDeepSup`` — 5 heads, each upsampled to full resolution; a
  5-tuple of logits.
- ``UNet3PlusDeepSupCGM`` — plus the classification-guided module on the
  bottleneck gating all 5 heads; it returns sigmoid *probabilities*, as the
  reference does.

Children are registered in the order flax creates them, under flax's names,
so ``state_dict`` keys mirror the flax tree.  Every module takes
``forward(x, generator=None)``: the generator drives CGM's dropout in
training mode and is ignored elsewhere.  ``remat`` / ``remat_policy``
rematerialize each block (``ops/remat.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.image import max_pool2d, max_pool_nd, upsample_bilinear2d
from ..ops.remat import resolve_policy
from .layers2d import (
    ConvBNReLU,
    DoubleConvolution,
    TorchConv,
    UNetConv2,
    UpSample,
    crop_and_concat,
)

FILTERS = (64, 128, 256, 512, 1024)
CAT_CHANNELS = FILTERS[0]
UP_CHANNELS = 5 * CAT_CHANNELS


class UNet(nn.Module):
    """Classic U-Net: four DoubleConv + max-pool levels down, a DoubleConv
    bottleneck, four ConvTranspose k2s2 + center-crop skip concat +
    DoubleConv levels up, and a 1x1 head.  ``base_features`` scales the
    channel progression (64 in the reference).

    Children are registered in the order flax creates them, under the same
    names (DoubleConvolution_0..8, UpSample_0..3, TorchConv_0), so the
    ``state_dict`` keys and order mirror the flax tree."""

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 base_features: int = 64, *, remat: bool = False,
                 remat_policy: Optional[str] = None, device=None):
        super().__init__()
        f = base_features
        downs = (f, 2 * f, 4 * f, 8 * f)
        self.levels = len(downs)
        rm = dict(remat=remat, remat_policy=resolve_policy(remat_policy),
                  device=device)
        c = in_channels
        for i, feats in enumerate(downs):
            setattr(self, f"DoubleConvolution_{i}",
                    DoubleConvolution(c, feats, **rm))
            c = feats
        self.DoubleConvolution_4 = DoubleConvolution(c, 16 * f, **rm)
        c = 16 * f
        for i, feats in enumerate(reversed(downs)):
            setattr(self, f"UpSample_{i}", UpSample(c, feats, device=device))
            setattr(self, f"DoubleConvolution_{5 + i}",
                    DoubleConvolution(2 * feats, feats, **rm))
            c = feats
        self.TorchConv_0 = TorchConv(c, out_channels, (1, 1), device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default conv init for every layer, drawn in
        registration order from ``generator``."""
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator  # no dropout in the classic UNet
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


class _UNet3PlusBackbone(nn.Module):
    """The shared encoder + full-scale-skip decoder of the UNet-3+ family:
    ``UNetConv2_0..4`` (encoder levels 1-5), then ``ConvBNReLU_0..23``, per
    decoder stage 4, 3, 2, 1 five branches (levels 1..5) and the fuse.
    Returns {1..4: decoder maps hd1..hd4, 5: the bottleneck}."""

    def __init__(self, in_channels: int = 3, *, is_batchnorm: bool = True,
                 bn_axis_name: Optional[str] = None, remat: bool = False,
                 remat_policy: Optional[str] = None, device=None):
        super().__init__()
        rm = dict(remat=remat, remat_policy=resolve_policy(remat_policy),
                  bn_axis_name=bn_axis_name, device=device)
        c = in_channels
        for lvl, feats in enumerate(FILTERS):
            setattr(self, f"UNetConv2_{lvl}",
                    UNetConv2(c, feats, is_batchnorm=is_batchnorm, **rm))
            c = feats
        width = {5: FILTERS[4]}  # channels of hd5; hd4..hd1 are UP_CHANNELS
        idx = 0
        for t in (4, 3, 2, 1):
            for lvl in range(1, 6):
                cin = FILTERS[lvl - 1] if lvl <= t else width[lvl]
                setattr(self, f"ConvBNReLU_{idx}",
                        ConvBNReLU(cin, CAT_CHANNELS, **rm))
                idx += 1
            setattr(self, f"ConvBNReLU_{idx}",
                    ConvBNReLU(UP_CHANNELS, UP_CHANNELS, **rm))
            idx += 1
            width[t] = UP_CHANNELS

    def reset_parameters(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        enc = {}
        for lvl in range(1, 6):
            if lvl > 1:
                x = max_pool2d(x, 2)
            x = getattr(self, f"UNetConv2_{lvl - 1}")(x)
            enc[lvl] = x
        hd = {5: enc[5]}
        idx = 0
        for t in (4, 3, 2, 1):
            branches = []
            for lvl in range(1, 6):
                if lvl < t:
                    src = max_pool_nd(enc[lvl], 2 ** (t - lvl),
                                      ceil_mode=True)
                elif lvl == t:
                    src = enc[lvl]
                else:
                    src = upsample_bilinear2d(hd[lvl], 2 ** (lvl - t),
                                              align_corners=False)
                branches.append(getattr(self, f"ConvBNReLU_{idx}")(src))
                idx += 1
            hd[t] = getattr(self, f"ConvBNReLU_{idx}")(
                torch.cat(branches, dim=-1))
            idx += 1
        return hd


class _UNet3PlusBase(nn.Module):
    """The backbone (``_UNet3PlusBackbone_0``) and the arguments the family
    shares; ``feature_scale`` and ``is_deconv`` are kept for config parity
    and unused, as in the reference."""

    def __init__(self, in_channels: int = 3, n_classes: int = 1,
                 feature_scale: int = 4, is_deconv: bool = True,
                 is_batchnorm: bool = True,
                 bn_axis_name: Optional[str] = None, *, remat: bool = False,
                 remat_policy: Optional[str] = None, device=None):
        super().__init__()
        self._UNet3PlusBackbone_0 = _UNet3PlusBackbone(
            in_channels, is_batchnorm=is_batchnorm, bn_axis_name=bn_axis_name,
            remat=remat, remat_policy=remat_policy, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset_parameters(generator)

    def _head(self, n_classes: int, device, name: str,
              in_features: int = UP_CHANNELS) -> None:
        setattr(self, name, TorchConv(in_features, n_classes, (3, 3),
                                      kernel_init="kaiming", device=device))

    def _deep_sup_heads(self, n_classes: int, device) -> None:
        for i in range(1, 6):  # hd1..hd4 are UP_CHANNELS wide, hd5 1024
            self._head(n_classes, device, f"outconv{i}",
                       UP_CHANNELS if i < 5 else FILTERS[4])

    def _deep_heads(self, hd) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i in range(1, 6):
            d = getattr(self, f"outconv{i}")(hd[i])
            if i > 1:
                d = upsample_bilinear2d(d, 2 ** (i - 1), align_corners=False)
            outs.append(d)
        return tuple(outs)


class UNet3Plus(_UNet3PlusBase):
    """UNet-3+: one 3×3 head (``TorchConv_0``) on hd1."""

    def __init__(self, in_channels: int = 3, n_classes: int = 1, *args,
                 device=None, **kw):
        super().__init__(in_channels, n_classes, *args, device=device, **kw)
        self._head(n_classes, device, "TorchConv_0")

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator
        return self.TorchConv_0(self._UNet3PlusBackbone_0(x)[1])


class UNet3PlusDeepSup(_UNet3PlusBase):
    """UNet-3+ with deep supervision: a 5-tuple (d1..d5) of full-resolution
    logits, dI a 3×3 head (``outconvI``) on hdI upsampled ×2^(I−1)."""

    def __init__(self, in_channels: int = 3, n_classes: int = 1, *args,
                 device=None, **kw):
        super().__init__(in_channels, n_classes, *args, device=device, **kw)
        self._deep_sup_heads(n_classes, device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, ...]:
        del generator
        return self._deep_heads(self._UNet3PlusBackbone_0(x))


class UNet3PlusDeepSupCGM(_UNet3PlusBase):
    """UNet-3+ with deep supervision and the classification-guided module:
    dropout 0.5 on hd5 (training mode only, drawn from ``generator``), a
    1×1 conv to 2 (``TorchConv_0``), a global max, a sigmoid and an argmax
    give each sample a 0/1 gate without gradient, multiplied into every
    head before its sigmoid.  Returns sigmoid probabilities, as the
    reference does."""

    dropout_rate = 0.5

    def __init__(self, in_channels: int = 3, n_classes: int = 1, *args,
                 device=None, **kw):
        super().__init__(in_channels, n_classes, *args, device=device, **kw)
        self.TorchConv_0 = TorchConv(FILTERS[4], 2, (1, 1),
                                     kernel_init="kaiming", device=device)
        self._deep_sup_heads(n_classes, device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, ...]:
        hd = self._UNet3PlusBackbone_0(x)
        cls = hd[5]
        if self.training:
            if generator is None:
                raise ValueError("UNet3PlusDeepSupCGM in training mode draws "
                                 "its dropout from an explicit generator")
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(cls.shape, generator=generator,
                              device=cls.device) < keep
            cls = torch.where(mask, cls / keep, torch.zeros_like(cls))
        cls = torch.sigmoid(self.TorchConv_0(cls).amax(dim=(1, 2)))
        gate = torch.argmax(cls, dim=1).to(hd[5].dtype)[:, None, None, None]
        return tuple(torch.sigmoid(d * gate) for d in self._deep_heads(hd))
