"""3D and 2D conv blocks built from layer-order strings (the JAX package's
``models/blocks3d.py``), channels-last: (N, D, H, W, C) when ``is3d``, else
(N, H, W, C).

The order string composes a conv layer out of:

    c = conv (bias only when no norm is in the order; any symmetric padding)
    g = GroupNorm (groups clamp to 1 when the channels are fewer; it
        normalizes the in- or out-channels by its place relative to 'c')
    b = BatchNorm with flax's semantics (momentum 0.9, eps 1e-5, batch
        statistics in training mode and running statistics in eval mode;
        ``ops/batchnorm.py``), under the flax scope name ``BatchNorm_0``
    r = ReLU  l = LeakyReLU  e = ELU
    d = dropout  D = channel dropout (whole (sample, channel) feature maps,
        torch Dropout3d), active in training mode only

Blocks: ``SingleConv``, ``DoubleConv`` (the encoder halves the channels of
its first conv unless upscale is 1, never below its input), ``ResNetBlock``
(1x1 shortcut when the channels change, conv2 with the full order, conv3
without its non-linearity, non-linearity after the sum), ``ResNetBlockSE``
(a ResNetBlock and a squeeze-excitation gate, ``models/se3d.py``),
``Encoder`` (optional pooling + block), ``TransposeConvUpsampling`` and
``Decoder`` (upsample + join + block: DoubleConv ⇒ nearest interpolation
and concat ``[skip, x]``; ResNetBlock ⇒ deconv and sum; an explicit mode
other than nearest and deconv ⇒ the bilinear / trilinear resize and
concat).

Unlike flax, a torch module builds its parameters up front, so every block
takes its input channel count.  Children carry the flax scope names
(``SingleConv1``, ``GroupNorm_0``, ``BatchNorm_0``, ``TorchConv_0``,
``conv1``, ``basic_module``, ``upsampling``, ``ResNetBlock_0``,
``ChannelSpatialSELayer_0``) so ``utils/param_bridge.py`` maps the two trees
leaf for leaf.

``dtype`` is flax's: None computes in the input's dtype; ``torch.bfloat16``
keeps the parameters float32 and casts x and each weight to bf16 at use
(flax's ``promote_dtype``), outside the autograd Functions, so autograd
hands each weight's gradient back to its float32 parameter.  GroupNorm keeps
float32 statistics and writes bf16; BatchNorm computes in float32 and
writes bf16.

A 3D ``SingleConv`` of order 'gcr' with a 3x3x3 kernel and padding 1 takes
the fused path (with int8 PTQ off, ``ops/quant.py``), as in the JAX package: the GroupNorm statistics kernel and
the fused GroupNorm-apply + conv3d + ReLU kernel (``ops/fused_conv.py``),
the normalized tensor never stored, in float32 or bf16.  Every other order
with 'g', every 2D block, and under bf16 compute the first SingleConv (whose
input, the float32 image, the JAX package normalizes in float32 before it
rounds the result to bf16) run the ``GroupNorm`` module (statistics and
affine kernels) and then ``TorchConv``.  Both are autograd Functions whose
backward runs the GroupNorm backward kernels.

``module.train()`` takes the place of the JAX package's ``train`` flag.  As
that flag defaults to False, ``SingleConv`` (and the models of
``unet3d.py``) start in eval mode.  Dropout draws its masks from the
generator that ``set_dropout_generator`` gives it (the global generator
until then).  Under remat a block runs twice; its ``replay`` record
(``ops/remat.py``) hands the recompute the first run's masks and keeps it
from updating the running statistics again.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import quant
from ..ops.fused_conv import gcr_fused_conv
from ..ops.image import (
    avg_pool_nd,
    interpolate_nearest_nd,
    max_pool_nd,
    resize_bilinear,
)
from ..ops.norm import GroupNorm
from ..parallel import tensor as tp
from .layers2d import TorchBatchNorm, TorchConv, TorchConvTranspose
from .se3d import se_module

IntOrTuple = Union[int, Sequence[int]]


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


class Dropout(nn.Module):
    """flax ``nn.Dropout`` in training mode: keep each element with
    probability 1 − p and scale it by 1 / (1 − p); ``channel=True`` draws one
    keep per (sample, channel) and broadcasts it over the spatial dims.  The
    identity in eval mode, which it starts in."""

    replay = None  # set by ops/remat.checkpoint_block around a recompute

    def __init__(self, p: float, channel: bool = False):
        super().__init__()
        self.p = float(p)
        self.channel = channel
        self.generator: Optional[torch.Generator] = None
        self.train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        shape = ((x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
                 if self.channel else x.shape)

        def draw():
            return torch.rand(shape, generator=self.generator,
                              device=x.device) >= self.p

        keep = draw() if self.replay is None else self.replay.keep_mask(draw)
        return x * keep / (1.0 - self.p)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Make every ``Dropout`` of ``model`` draw from ``generator`` (on the
    device of the activations)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class SingleConv(nn.Module):
    """Order-string conv layer (reference SingleConv)."""

    replay = None  # set by ops/remat.checkpoint_block around a recompute

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrTuple = 3, order: str = "gcr",
                 num_groups: int = 8, padding: IntOrTuple = 1,
                 dropout_prob: float = 0.1, is3d: bool = True,
                 dtype: Optional[torch.dtype] = None, *, device=None):
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
        nsp = 3 if is3d else 2
        ks = _ktuple(kernel_size, nsp)
        pad = _ktuple(padding, nsp)
        self.order = order
        self.dtype = dtype
        channels = in_channels
        for char in order:
            if char == "c":
                self.TorchConv_0 = TorchConv(
                    in_channels, out_channels, ks, padding=pad,
                    use_bias=not ("g" in order or "b" in order), dtype=dtype,
                    device=device)
                channels = out_channels
            elif char == "g":
                groups = 1 if channels < num_groups else num_groups
                if channels % groups:
                    raise ValueError(
                        f"Expected number of channels in input to be "
                        f"divisible by num_groups. num_channels={channels}, "
                        f"num_groups={groups}")
                self.GroupNorm_0 = GroupNorm(channels, groups, 1e-5,
                                             dtype=dtype, device=device)
            elif char == "b":
                self.BatchNorm_0 = TorchBatchNorm(channels, device=device)
            elif char == "d":
                self.dropout = Dropout(dropout_prob)
            elif char == "D":
                self.channel_dropout = Dropout(dropout_prob, channel=True)
        # the fused path: GN statistics kernel + fused GN-apply/conv/ReLU
        self.fused = (order == "gcr" and is3d and ks == (3, 3, 3)
                      and pad == (1, 1, 1))
        self.train(False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_tree(self, generator)

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.BatchNorm_0
        y, stats = bn.normalize(x)
        if self.replay is None or not self.replay.recompute:
            bn.update(stats)
        return y if self.dtype is None else y.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the fused kernel reads x in the compute dtype; an input in another
        # dtype (the float32 image under bf16 compute) is normalized in its
        # own dtype and rounded once, as the JAX package's GroupNorm does.
        # Under int8 PTQ (calib or int8) the conv goes through TorchConv, so
        # the fused kernel stands aside, as in the JAX package.
        # Under channel tensor parallelism (parallel/tensor.py) kernel 2
        # runs on this rank's out-channel block of the kernel: x and the
        # whole GroupNorm scale and bias enter through copy_to_model, so
        # the partial gradients of its backward are summed over the model
        # axis, and the output blocks are gathered.
        if (self.fused and (self.dtype is None or x.dtype == self.dtype)
                and quant.mode() == "off"):
            gn = self.GroupNorm_0
            kernel, _ = self.TorchConv_0.hwio(x.dtype)
            return tp.column_parallel(
                self.TorchConv_0, lambda xc, scale, bias: gcr_fused_conv(
                    xc.contiguous(), scale, bias, kernel, gn.num_groups,
                    gn.epsilon),
                x, tp.full_param(gn, "weight"), tp.full_param(gn, "bias"))
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
            elif char == "b":
                x = self._batch_norm(x)
            elif char == "d":
                x = self.dropout(x)
            elif char == "D":
                x = self.channel_dropout(x)
        return x


class DoubleConv(nn.Module):
    """Two SingleConvs; the encoder halves the channels of conv1 (unless
    upscale == 1, never below in_channels).  ``dropout_prob`` is one rate
    or a (conv1, conv2) pair."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool,
                 kernel_size: IntOrTuple = 3, order: str = "gcr",
                 num_groups: int = 8, padding: IntOrTuple = 1,
                 upscale: int = 2,
                 dropout_prob: Union[float, Sequence[float]] = 0.1,
                 is3d: bool = True, dtype: Optional[torch.dtype] = None, *,
                 device=None):
        super().__init__()
        if isinstance(dropout_prob, (list, tuple)):
            p1, p2 = dropout_prob
        else:
            p1 = p2 = dropout_prob
        if encoder:
            conv1_out = out_channels if upscale == 1 else out_channels // 2
            conv1_out = max(conv1_out, in_channels)
        else:
            conv1_out = out_channels
        self.SingleConv1 = SingleConv(in_channels, conv1_out, kernel_size,
                                      order, num_groups, padding, p1, is3d,
                                      dtype, device=device)
        self.SingleConv2 = SingleConv(conv1_out, out_channels, kernel_size,
                                      order, num_groups, padding, p2, is3d,
                                      dtype, device=device)

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
                 num_groups: int = 8, is3d: bool = True,
                 dtype: Optional[torch.dtype] = None, *, device=None):
        super().__init__()
        nsp = 3 if is3d else 2
        if in_channels != out_channels:
            self.conv1 = TorchConv(in_channels, out_channels, (1,) * nsp,
                                   dtype=dtype, device=device)
        else:
            self.conv1 = None
        self.order = order
        self.conv2 = SingleConv(out_channels, out_channels, kernel_size,
                                order, num_groups, is3d=is3d, dtype=dtype,
                                device=device)
        n_order = order
        for c in "rel":
            n_order = n_order.replace(c, "")
        self.conv3 = SingleConv(out_channels, out_channels, kernel_size,
                                n_order, num_groups, is3d=is3d, dtype=dtype,
                                device=device)

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


class ResNetBlockSE(nn.Module):
    """A ResNetBlock followed by the concurrent channel and spatial
    squeeze-excitation gate (scSE, as the JAX model family always builds
    it)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrTuple = 3, order: str = "cge",
                 num_groups: int = 8, is3d: bool = True,
                 dtype: Optional[torch.dtype] = None, *, device=None):
        super().__init__()
        self.ResNetBlock_0 = ResNetBlock(in_channels, out_channels,
                                         kernel_size, order, num_groups,
                                         is3d, dtype, device=device)
        self.ChannelSpatialSELayer_0 = se_module(
            "scse", out_channels, 3 if is3d else 2, dtype=dtype,
            device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_tree(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ChannelSpatialSELayer_0(self.ResNetBlock_0(x))


def _make_basic_module(basic_module: str, in_channels: int,
                       out_channels: int, *, encoder: bool,
                       kernel_size: IntOrTuple, order: str, num_groups: int,
                       padding: IntOrTuple, upscale: int, dropout_prob,
                       is3d: bool, dtype, device) -> nn.Module:
    if basic_module == "DoubleConv":
        return DoubleConv(in_channels, out_channels, encoder, kernel_size,
                          order, num_groups, padding, upscale, dropout_prob,
                          is3d, dtype, device=device)
    if basic_module == "ResNetBlock":
        return ResNetBlock(in_channels, out_channels, kernel_size, order,
                           num_groups, is3d, dtype, device=device)
    if basic_module == "ResNetBlockSE":
        return ResNetBlockSE(in_channels, out_channels, kernel_size, order,
                             num_groups, is3d, dtype, device=device)
    raise ValueError(f"Unsupported basic_module {basic_module!r}")


class Encoder(nn.Module):
    """Optional max/avg pooling + the basic block."""

    def __init__(self, in_channels: int, out_channels: int,
                 conv_kernel_size: IntOrTuple = 3, apply_pooling: bool = True,
                 pool_kernel_size: IntOrTuple = 2, pool_type: str = "max",
                 basic_module: str = "DoubleConv",
                 conv_layer_order: str = "gcr", num_groups: int = 8,
                 padding: IntOrTuple = 1, upscale: int = 2,
                 dropout_prob: Union[float, Sequence[float]] = 0.1,
                 is3d: bool = True, dtype: Optional[torch.dtype] = None, *,
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
            dropout_prob=dropout_prob, is3d=is3d, dtype=dtype, device=device)

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
                 is3d: bool = True, dtype: Optional[torch.dtype] = None, *,
                 device=None):
        nsp = 3 if is3d else 2
        super().__init__(in_channels, out_channels, _ktuple(kernel_size, nsp),
                         _ktuple(scale_factor, nsp), padding=1,
                         use_bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, output_size: Sequence[int]
                ) -> torch.Tensor:
        return interpolate_nearest_nd(super().forward(x), output_size)


class Decoder(nn.Module):
    """Upsample + join + basic block.  'default' upsampling: DoubleConv ⇒
    nearest interpolation and concat ``[skip, x]``; ResNetBlock ⇒ deconv and
    sum.  An explicit 'nearest' concats, 'deconv' sums, any other mode
    (the interpolating 'linear' / 'bilinear' / 'trilinear' / ...) runs the
    bilinear or trilinear resize and concats; None or 'none' concats x as it
    is.  ``in_channels`` are x's, ``skip_channels`` the encoder
    features'."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, conv_kernel_size: IntOrTuple = 3,
                 scale_factor: IntOrTuple = 2,
                 basic_module: str = "DoubleConv",
                 conv_layer_order: str = "gcr", num_groups: int = 8,
                 padding: IntOrTuple = 1, upsample: Optional[str] = "default",
                 dropout_prob: Union[float, Sequence[float]] = 0.1,
                 is3d: bool = True, dtype: Optional[torch.dtype] = None, *,
                 device=None):
        super().__init__()
        if upsample is None or upsample == "none":
            mode, concat = None, True
        elif upsample == "default":
            deconv = basic_module != "DoubleConv"
            mode, concat = ("deconv", False) if deconv else ("nearest", True)
        elif upsample == "deconv":
            mode, concat = "deconv", False
        elif upsample == "nearest":
            mode, concat = "nearest", True
        else:
            mode, concat = "linear", True
        self.mode, self.concat = mode, concat
        if mode == "deconv":
            self.upsampling = TransposeConvUpsampling(
                in_channels, out_channels, conv_kernel_size, scale_factor,
                is3d, dtype, device=device)
            x_channels = out_channels
        else:
            x_channels = in_channels
        block_in = skip_channels + x_channels if concat else x_channels
        self.basic_module = _make_basic_module(
            basic_module, block_in, out_channels, encoder=False,
            kernel_size=conv_kernel_size, order=conv_layer_order,
            num_groups=num_groups, padding=padding, upscale=2,
            dropout_prob=dropout_prob, is3d=is3d, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_tree(self, generator)

    def forward(self, encoder_features: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        output_size = encoder_features.shape[1:-1]
        if self.mode == "deconv":
            x = self.upsampling(x, output_size)
        elif self.mode == "nearest":
            x = interpolate_nearest_nd(x, output_size)
        elif self.mode == "linear":
            x = resize_bilinear(x, output_size)
        if self.concat:
            x = torch.cat([encoder_features, x], dim=-1)
        else:
            x = encoder_features + x
        return self.basic_module(x)
