"""3D conv blocks built from layer-order strings (the JAX package's
``models/blocks3d.py``), channels-last (N, D, H, W, C).

The order string composes a conv layer out of:

    c = conv (bias only when no norm is in the order)
    g = GroupNorm (groups clamp to 1 when the channels are fewer; it
        normalizes the in- or out-channels by its place relative to 'c')
    r = ReLU  l = LeakyReLU  e = ELU
    d, D = dropout (identity: the port runs inference only so far)
    b = BatchNorm (not ported yet: ROADMAP item 16)

Blocks: ``SingleConv``, ``DoubleConv`` (the encoder halves the channels of
its first conv unless upscale is 1, never below its input), ``ResNetBlock``
(1x1 shortcut when the channels change, conv2 with the full order, conv3
without its non-linearity, non-linearity after the sum), ``Encoder``
(optional pooling + block), ``TransposeConvUpsampling`` and ``Decoder``
(upsample + join + block: DoubleConv ⇒ nearest interpolation and concat
``[skip, x]``; ResNetBlock ⇒ deconv and sum).

Unlike flax, a torch module builds its parameters up front, so every block
takes its input channel count.  Children carry the flax scope names
(``SingleConv1``, ``GroupNorm_0``, ``TorchConv_0``, ``conv1``,
``basic_module``, ``upsampling``) so ``utils/param_bridge.py`` maps the two
trees leaf for leaf.

A ``SingleConv`` of order 'gcr' with a 3x3x3 kernel and padding 1 takes the
fused path, as in the JAX package: the GroupNorm statistics kernel and the
fused GroupNorm-apply + conv3d + ReLU kernel (``ops/fused_conv.py``), the
normalized tensor never stored.  Every other order with 'g' runs the
``GroupNorm`` module (statistics and affine kernels) and then ``TorchConv``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_conv import gcr_fused_conv
from ..ops.image import avg_pool_nd, interpolate_nearest_nd, max_pool_nd
from ..ops.norm import GroupNorm
from .layers2d import TorchConv, TorchConvTranspose

IntOrTuple = Union[int, Sequence[int]]

BATCHNORM_ITEM = "ROADMAP.md queue 1, item 16 (BatchNorm layer orders)"
SE_ITEM = "ROADMAP.md queue 1, item 16 (ResNetBlockSE and models/se3d.py)"


def _ktuple(k: IntOrTuple, nsp: int) -> Tuple[int, ...]:
    return (k,) * nsp if isinstance(k, int) else tuple(k)


def reset_tree(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv's PyTorch default init from ``generator`` (GroupNorm
    to ones and zeros), children in registration order."""
    for child in module.children():
        if hasattr(child, "reset_parameters"):
            child.reset_parameters(generator)
        else:
            reset_tree(child, generator)


class SingleConv(nn.Module):
    """Order-string conv layer (reference SingleConv)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrTuple = 3, order: str = "gcr",
                 num_groups: int = 8, padding: IntOrTuple = 1, *,
                 device=None):
        super().__init__()
        if "c" not in order:
            raise ValueError("Conv layer MUST be present")
        if order[0] in "rle":
            raise ValueError(
                "Non-linearity cannot be the first operation in the layer")
        bad = set(order) - set("gcrleDdb")
        if bad:
            raise ValueError(f"Unsupported layer type {sorted(bad)}. MUST be "
                             f"one of ['b', 'g', 'r', 'l', 'e', 'c', 'd', 'D']")
        if "b" in order:
            raise NotImplementedError(f"order {order!r}: {BATCHNORM_ITEM}")
        ks = _ktuple(kernel_size, 3)
        pad = _ktuple(padding, 3)
        if pad != tuple(k // 2 for k in ks):
            raise NotImplementedError(
                f"padding {pad} for kernel {ks}: the port's TorchConv pads "
                "'SAME'")
        self.order = order
        channels = in_channels
        for char in order:
            if char == "c":
                self.TorchConv_0 = TorchConv(
                    in_channels, out_channels, ks,
                    use_bias="g" not in order, device=device)
                channels = out_channels
            elif char == "g":
                groups = 1 if channels < num_groups else num_groups
                if channels % groups:
                    raise ValueError(
                        f"Expected number of channels in input to be "
                        f"divisible by num_groups. num_channels={channels}, "
                        f"num_groups={groups}")
                self.GroupNorm_0 = GroupNorm(channels, groups, 1e-5,
                                             device=device)
        # the fused path: GN statistics kernel + fused GN-apply/conv/ReLU
        self.fused = order == "gcr" and ks == (3, 3, 3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_tree(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            gn = self.GroupNorm_0
            kernel, _ = self.TorchConv_0.hwio()
            return gcr_fused_conv(x.contiguous(), gn.weight, gn.bias, kernel,
                                  gn.num_groups, gn.epsilon)
        for char in self.order:
            if char == "r":
                x = F.relu(x)
            elif char == "l":
                x = F.leaky_relu(x, negative_slope=0.01)
            elif char == "e":
                x = F.elu(x)
            elif char == "c":
                x = self.TorchConv_0(x)
            elif char == "g":
                x = self.GroupNorm_0(x)
        return x


class DoubleConv(nn.Module):
    """Two SingleConvs; the encoder halves the channels of conv1 (unless
    upscale == 1, never below in_channels)."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool,
                 kernel_size: IntOrTuple = 3, order: str = "gcr",
                 num_groups: int = 8, padding: IntOrTuple = 1,
                 upscale: int = 2, *, device=None):
        super().__init__()
        if encoder:
            conv1_out = out_channels if upscale == 1 else out_channels // 2
            conv1_out = max(conv1_out, in_channels)
        else:
            conv1_out = out_channels
        self.SingleConv1 = SingleConv(in_channels, conv1_out, kernel_size,
                                      order, num_groups, padding,
                                      device=device)
        self.SingleConv2 = SingleConv(conv1_out, out_channels, kernel_size,
                                      order, num_groups, padding,
                                      device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_tree(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SingleConv2(self.SingleConv1(x))


class ResNetBlock(nn.Module):
    """Residual block: 1x1 shortcut if the channels change, conv2 with the
    full order, conv3 without its non-linearity, non-linearity after the
    sum."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrTuple = 3, order: str = "cge",
                 num_groups: int = 8, *, device=None):
        super().__init__()
        if in_channels != out_channels:
            self.conv1 = TorchConv(in_channels, out_channels, (1, 1, 1),
                                   device=device)
        else:
            self.conv1 = None
        self.order = order
        self.conv2 = SingleConv(out_channels, out_channels, kernel_size,
                                order, num_groups, device=device)
        n_order = order
        for c in "rel":
            n_order = n_order.replace(c, "")
        self.conv3 = SingleConv(out_channels, out_channels, kernel_size,
                                n_order, num_groups, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_tree(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.conv1 is None else self.conv1(x)
        out = self.conv3(self.conv2(residual))
        out = out + residual
        if "l" in self.order:
            return F.leaky_relu(out, negative_slope=0.1)
        if "e" in self.order:
            return F.elu(out)
        return F.relu(out)


def _make_basic_module(basic_module: str, in_channels: int,
                       out_channels: int, *, encoder: bool,
                       kernel_size: IntOrTuple, order: str, num_groups: int,
                       padding: IntOrTuple, upscale: int,
                       device) -> nn.Module:
    if basic_module == "DoubleConv":
        return DoubleConv(in_channels, out_channels, encoder, kernel_size,
                          order, num_groups, padding, upscale, device=device)
    if basic_module == "ResNetBlock":
        return ResNetBlock(in_channels, out_channels, kernel_size, order,
                           num_groups, device=device)
    if basic_module == "ResNetBlockSE":
        raise NotImplementedError(f"basic_module 'ResNetBlockSE': {SE_ITEM}")
    raise ValueError(f"Unsupported basic_module {basic_module!r}")


class Encoder(nn.Module):
    """Optional max/avg pooling + the basic block."""

    def __init__(self, in_channels: int, out_channels: int,
                 conv_kernel_size: IntOrTuple = 3, apply_pooling: bool = True,
                 pool_kernel_size: IntOrTuple = 2, pool_type: str = "max",
                 basic_module: str = "DoubleConv",
                 conv_layer_order: str = "gcr", num_groups: int = 8,
                 padding: IntOrTuple = 1, upscale: int = 2, *,
                 device=None):
        super().__init__()
        if pool_type not in ("max", "avg"):
            raise ValueError(f"pool_type {pool_type!r}: 'max' or 'avg'")
        self.apply_pooling = apply_pooling
        self.pool = max_pool_nd if pool_type == "max" else avg_pool_nd
        self.pool_kernel_size = pool_kernel_size
        self.basic_module = _make_basic_module(
            basic_module, in_channels, out_channels, encoder=True,
            kernel_size=conv_kernel_size, order=conv_layer_order,
            num_groups=num_groups, padding=padding, upscale=upscale,
            device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_tree(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.apply_pooling:
            x = self.pool(x, self.pool_kernel_size)
        return self.basic_module(x)


class TransposeConvUpsampling(TorchConvTranspose):
    """ConvTranspose (k = conv kernel, stride = scale, padding 1, no bias)
    and a nearest interpolation to the skip's exact size."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrTuple = 3, scale_factor: IntOrTuple = 2,
                 *, device=None):
        super().__init__(in_channels, out_channels, _ktuple(kernel_size, 3),
                         _ktuple(scale_factor, 3), padding=1, use_bias=False,
                         device=device)

    def forward(self, x: torch.Tensor, output_size: Sequence[int]
                ) -> torch.Tensor:
        return interpolate_nearest_nd(super().forward(x), output_size)


class Decoder(nn.Module):
    """Upsample + join + basic block.  'default' upsampling: DoubleConv ⇒
    nearest interpolation and concat ``[skip, x]``; ResNetBlock ⇒ deconv and
    sum.  ``in_channels`` are x's, ``skip_channels`` the encoder
    features'."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, conv_kernel_size: IntOrTuple = 3,
                 scale_factor: IntOrTuple = 2,
                 basic_module: str = "DoubleConv",
                 conv_layer_order: str = "gcr", num_groups: int = 8,
                 padding: IntOrTuple = 1, upsample: Optional[str] = "default",
                 *, device=None):
        super().__init__()
        if upsample is None or upsample == "none":
            mode, concat = None, True
        elif upsample == "default":
            deconv = basic_module != "DoubleConv"
            mode, concat = ("deconv", False) if deconv else ("nearest", True)
        elif upsample in ("nearest", "deconv"):
            mode, concat = upsample, upsample == "nearest"
        else:
            raise NotImplementedError(
                f"upsample {upsample!r}: only nearest interpolation and the "
                "deconv are ported (ROADMAP.md queue 1, item 16)")
        self.mode, self.concat = mode, concat
        if mode == "deconv":
            self.upsampling = TransposeConvUpsampling(
                in_channels, out_channels, conv_kernel_size, scale_factor,
                device=device)
            x_channels = out_channels
        else:
            x_channels = in_channels
        block_in = skip_channels + x_channels if concat else x_channels
        self.basic_module = _make_basic_module(
            basic_module, block_in, out_channels, encoder=False,
            kernel_size=conv_kernel_size, order=conv_layer_order,
            num_groups=num_groups, padding=padding, upscale=2,
            device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_tree(self, generator)

    def forward(self, encoder_features: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        output_size = encoder_features.shape[1:-1]
        if self.mode == "deconv":
            x = self.upsampling(x, output_size)
        elif self.mode == "nearest":
            x = interpolate_nearest_nd(x, output_size)
        if self.concat:
            x = torch.cat([encoder_features, x], dim=-1)
        else:
            x = encoder_features + x
        return self.basic_module(x)
