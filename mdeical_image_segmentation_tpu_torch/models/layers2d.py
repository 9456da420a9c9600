"""2D layers, channels-last (the JAX package's ``models/layers2d.py``);
``TorchConv`` and ``TorchConvTranspose`` also take 3D kernels for the 3D UNet
family.

Activations are channels-last at every module boundary.  Parameters are
stored the PyTorch way (``weight`` (O, I, *k), ConvTranspose ``weight``
(I, O, *k)) under module names that mirror the flax tree, so
``utils/param_bridge.py`` maps one onto the other leaf for leaf.  Modules
build their parameters empty on a given device; ``reset_parameters(
generator)`` draws them from an explicit generator: PyTorch's default conv
init, or the ``init_weights`` scheme named by ``kernel_init``
(``ops/initializers.py``).

``TorchBatchNorm`` keeps flax's BatchNorm semantics (``ops/batchnorm.py``):
float32 statistics by the fast variance, the running variance updated with
the biased batch variance at momentum 0.9, eps 1e-5, parameters and running
statistics float32 under any compute dtype.

Under channel tensor parallelism (``parallel/tensor.py``) a sharded conv
holds its block of the out-channels and computes ``gather(conv(copy(x)))``
over the model axis; a sharded BatchNorm gathers its scale and bias and
normalizes the full tensor; ``DoubleConvolution`` runs its two convs apart
(kernel 1's single-conv launch each) around the all-gather.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import batchnorm
from ..ops import initializers as tinit
from ..ops import quant
from ..ops.fused_conv import conv2d_relu, double_conv2d, fused_double2d
from ..ops.image import center_crop, upsample_bilinear2d
from ..ops.remat import run_block, run_stages
from ..parallel import mesh as mesh_lib
from ..parallel import tensor as tp

def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, *range(2, x.ndim), 1)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding of one dim: (before, after)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class TorchConv(nn.Module):
    """Channels-last conv (2D or 3D by ``len(kernel_size)``) with flax's
    'SAME' padding (odd kernels; under a stride the extra row goes after,
    as XLA pads), or an explicit symmetric ``padding`` per spatial dim
    (stride 1), bias optional.  ``kernel_init`` is 'torch_default' or an
    ``init_weights`` scheme ('normal', 'xavier', 'kaiming', 'orthogonal');
    the bias always takes PyTorch's default.  ``dtype`` set (flax's
    ``dtype``): x, weight and bias are cast to it at use, the parameters
    stay float32; unset, the conv computes in x's dtype."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (3, 3), *,
                 strides: Optional[Sequence[int]] = None,
                 padding: Optional[Sequence[int]] = None,
                 use_bias: bool = True, kernel_init: str = "torch_default",
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        ks = tuple(kernel_size)
        if len(ks) not in (2, 3) or any(k % 2 == 0 for k in ks):
            raise ValueError(f"TorchConv takes odd 2D or 3D kernels, got {ks}")
        tinit.conv_kernel_init(kernel_init)  # unknown names raise here
        self.kernel_size = ks
        self.strides = tuple(strides) if strides else (1,) * len(ks)
        if padding is not None and self.strides != (1,) * len(ks):
            raise ValueError("TorchConv takes an explicit padding at stride 1"
                             " only")
        self.kernel_init = kernel_init
        self.dtype = dtype
        self.padding = (tuple(k // 2 for k in ks) if padding is None
                        else tuple(padding))
        self._conv = F.conv2d if len(ks) == 2 else F.conv3d
        self.weight = nn.Parameter(
            torch.empty((features, in_features, *ks), device=device))
        self.bias = (nn.Parameter(torch.empty((features,), device=device))
                     if use_bias else None)
        # (weight version, its int8 quantization): outside the state_dict
        self._quantized = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        tinit.init_conv_(self.weight, self.bias, self.kernel_init, generator)

    def hwio(self, dtype: Optional[torch.dtype] = None,
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(kernel in the JAX layout (*k, I, O), bias), contiguous and cast
        to ``dtype`` (the parameters' own by default) — what the fused
        kernels take."""
        w, b = self.weight, self.bias
        dtype = dtype or w.dtype
        w = w.permute(*range(2, w.ndim), 1, 0).contiguous().to(dtype)
        return w, (None if b is None else b.to(dtype))

    def _pads(self, x: torch.Tensor) -> List[Tuple[int, int]]:
        """(before, after) padding per spatial dim: the explicit padding, or
        flax's 'SAME' under a stride."""
        if self.strides == (1,) * len(self.strides):
            return [(p, p) for p in self.padding]
        return [_same_pads(n, k, s) for n, k, s in
                zip(x.shape[1:-1], self.kernel_size, self.strides)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp.column_parallel(self, self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        qmode = quant.mode()
        if qmode != "off" and quant.quantizable(self.kernel_size, x.shape[-1]):
            if qmode == "int8":
                return self._int8_forward(x)
            quant.observe(self, x)  # calib: the float conv's input absmax
        if self.dtype is not None:
            x = x.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        padding = self.padding
        if self.strides != (1,) * len(self.strides):
            pads = self._pads(x)
            if all(lo == hi for lo, hi in pads):
                padding = tuple(lo for lo, _ in pads)
            else:  # F.pad order: last dim first; channels unpadded
                x = F.pad(x, [0, 0] + [p for lo_hi in reversed(pads)
                                       for p in lo_hi])
                padding = 0
        y = self._conv(_channels_first(x), self.weight.to(x.dtype), bias,
                       stride=self.strides, padding=padding)
        return _channels_last(y)

    def _int8_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The W8A8 conv (``ops/quant.py``): x quantized in its own dtype
        with the calibrated scale, the weight per output channel (once per
        weight version), the float32 rescale and bias, rounded to ``dtype``
        (x's dtype when unset)."""
        x_scale = quant.x_scale(self)
        w = self.weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if self._quantized is None or self._quantized[0] != key:
            self._quantized = (key, quant.quantize_weight(w))
        return quant.int8_conv(x.contiguous(), self._quantized[1], x_scale,
                               pads=self._pads(x), strides=self.strides,
                               bias=self.bias,
                               out_dtype=self.dtype or x.dtype)


class TorchConvTranspose(nn.Module):
    """Channels-last ``nn.ConvTranspose{2,3}d(k, s, padding)`` (2D or 3D by
    ``len(kernel_size)``), bias optional; ``dtype`` as for ``TorchConv``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (2, 2),
                 strides: Sequence[int] = (2, 2), *, padding: int = 0,
                 use_bias: bool = True, kernel_init: str = "torch_default",
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        ks = tuple(kernel_size)
        tinit.conv_kernel_init(kernel_init)
        self.kernel_init = kernel_init
        self.dtype = dtype
        self.strides = tuple(strides)
        self.padding = padding
        self._conv = {2: F.conv_transpose2d, 3: F.conv_transpose3d}[len(ks)]
        self.weight = nn.Parameter(torch.empty(
            (in_features, features, *ks), device=device))
        self.bias = (nn.Parameter(torch.empty((features,), device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch counts fan_in of (I, O, *k) over dim 1: O * prod(k)
        tinit.init_conv_(self.weight, self.bias, self.kernel_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp.column_parallel(self, self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = self._conv(_channels_first(x), self.weight.to(x.dtype), bias,
                       stride=self.strides, padding=self.padding)
        return _channels_last(y)


class TorchBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of a channels-last tensor
    (momentum 0.9, eps 1e-5): batch statistics in training mode, running
    statistics in eval mode.  ``weight`` / ``bias`` are flax's ``scale`` /
    ``bias``; ``running_mean`` / ``running_var`` its ``batch_stats`` ``mean``
    / ``var``.  No ``num_batches_tracked``: flax has none.  ``init_type``
    set draws the scale from N(1, 0.02²), else ones.  In training under
    data parallelism (``parallel.rows_split``) the batch statistics are the
    global batch's, whether or not ``axis_name`` is set: the JAX package's
    GSPMD program computes them so either way."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, features: int, *, init_type: Optional[str] = None,
                 axis_name: Optional[str] = None, device=None):
        super().__init__()
        self.init_type = init_type
        self.weight = nn.Parameter(torch.empty((features,), device=device))
        self.bias = nn.Parameter(torch.empty((features,), device=device))
        self.register_buffer("running_mean",
                             torch.zeros((features,), device=device))
        self.register_buffer("running_var",
                             torch.ones((features,), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.init_type:
                tinit.norm_scale_002(self.weight, generator)
            else:
                self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def normalize(self, x: torch.Tensor):
        """(y in x's dtype, the batch statistics to update with, or None in
        eval mode); leaves the running statistics alone."""
        weight, bias = tp.full_param(self, "weight"), tp.full_param(
            self, "bias")
        if self.training:
            y, mean, var = batchnorm.batch_norm_train(
                x, weight, bias, self.eps, mesh_lib.split_mesh())
            return y, (mean, var)
        return batchnorm.normalize(x, self.running_mean, self.running_var,
                                   weight, bias, self.eps), None

    @torch.no_grad()
    def update(self, stats) -> None:
        """``ra = 0.9·ra + 0.1·batch`` for the mean and the biased var."""
        if stats is None:
            return
        m = self.momentum
        for ra, batch in zip((self.running_mean, self.running_var), stats):
            ra.copy_(m * ra + (1.0 - m) * batch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, stats = self.normalize(x)
        self.update(stats)
        return y


class ConvBNReLU(nn.Module):
    """conv3x3 + BN + ReLU, the triple of UNet-3+'s decoder (kaiming conv,
    BN scale N(1, 0.02²))."""

    def __init__(self, in_features: int, features: int, *,
                 kernel_init: str = "kaiming",
                 bn_init_type: Optional[str] = "kaiming",
                 bn_axis_name: Optional[str] = None, remat: bool = False,
                 remat_policy: Optional[str] = None, device=None):
        super().__init__()
        self.remat, self.remat_policy = remat, remat_policy
        self.TorchConv_0 = TorchConv(in_features, features, (3, 3),
                                     kernel_init=kernel_init, device=device)
        self.TorchBatchNorm_0 = TorchBatchNorm(
            features, init_type=bn_init_type, axis_name=bn_axis_name,
            device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_stages([(self.TorchConv_0, self.TorchBatchNorm_0)], x,
                          remat=self.remat, policy=self.remat_policy)


class UNetConv2(nn.Module):
    """n × (conv [+ BN] + ReLU), kaiming-initialized (the reference's
    ``unetConv2``).  Children in flax's order: TorchConv_0,
    TorchBatchNorm_0, TorchConv_1, ..."""

    def __init__(self, in_features: int, features: int, *,
                 is_batchnorm: bool = True, n: int = 2, kernel_size: int = 3,
                 stride: int = 1, bn_axis_name: Optional[str] = None,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 device=None):
        super().__init__()
        self.n, self.is_batchnorm = n, is_batchnorm
        self.remat, self.remat_policy = remat, remat_policy
        c = in_features
        for i in range(n):
            setattr(self, f"TorchConv_{i}", TorchConv(
                c, features, (kernel_size, kernel_size),
                strides=(stride, stride), kernel_init="kaiming",
                device=device))
            if is_batchnorm:
                setattr(self, f"TorchBatchNorm_{i}", TorchBatchNorm(
                    features, init_type="kaiming", axis_name=bn_axis_name,
                    device=device))
            c = features

    def reset_parameters(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stages = [(getattr(self, f"TorchConv_{i}"),
                   getattr(self, f"TorchBatchNorm_{i}")
                   if self.is_batchnorm else None) for i in range(self.n)]
        return run_stages(stages, x, remat=self.remat,
                          policy=self.remat_policy)


class UNetUp(nn.Module):
    """Upsample (ConvTranspose k4 s2 p1, kaiming, or ×2 bilinear with
    align_corners=True) + concat of the skips + UNetConv2 without BN (the
    reference's ``unetUp``).  ``in_features`` is x's width, ``cat_features``
    the skips' widths summed."""

    def __init__(self, in_features: int, features: int, cat_features: int,
                 *, is_deconv: bool = True, device=None):
        super().__init__()
        self.is_deconv = is_deconv
        if is_deconv:
            self.TorchConvTranspose_0 = TorchConvTranspose(
                in_features, features, (4, 4), (2, 2), padding=1,
                kernel_init="kaiming", device=device)
            up = features
        else:
            up = in_features
        self.UNetConv2_0 = UNetConv2(up + cat_features, features,
                                     is_batchnorm=False, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, x: torch.Tensor, *skips: torch.Tensor) -> torch.Tensor:
        if self.is_deconv:
            x = self.TorchConvTranspose_0(x)
        else:
            x = upsample_bilinear2d(x, 2, align_corners=True)
        x = torch.cat([x, *skips], dim=-1)
        return self.UNetConv2_0(x)


class UNetUpOrigin(UNetUp):
    """The nested UNet's up block (the reference's ``unetUp_origin``): the
    same upsample choices, its conv reading ``in + (n_concat − 2)·out``
    channels, which channels-last concatenation gives as it is."""


class DoubleConvolution(nn.Module):
    """2 × (conv3x3 + ReLU) as one call of kernel 1: the CUDA kernel on a
    CUDA tensor, the plain two-conv version on a CPU tensor.  The weights
    are cast to x's dtype at use (fp32 master weights under bf16 compute).
    While autograd records, the call is ``double_conv2d`` (z kept for the
    backward); otherwise ``fused_double2d`` without z (serving).  Under
    remat with the ``None`` policy the whole call is recomputed in the
    backward (``ops/remat.py``)."""

    def __init__(self, in_features: int, features: int, *,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 device=None):
        super().__init__()
        self.remat, self.remat_policy = remat, remat_policy
        self.TorchConv_0 = TorchConv(in_features, features, device=device)
        self.TorchConv_1 = TorchConv(features, features, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.TorchConv_0.reset_parameters(generator)
        self.TorchConv_1.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_block(self._forward, x, remat=self.remat,
                         policy=self.remat_policy)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.mode() != "off":
            # int8 PTQ calibrates and quantizes through TorchConv: kernel 1
            # would bypass both convs, so it stands aside, as in JAX
            x = F.relu(self.TorchConv_0(x))
            return F.relu(self.TorchConv_1(x))
        w1, b1 = self.TorchConv_0.hwio(x.dtype)
        w2, b2 = self.TorchConv_1.hwio(x.dtype)
        x = x.contiguous()
        if tp.is_sharded(self.TorchConv_0) or tp.is_sharded(self.TorchConv_1):
            # each conv on this rank's out-channel block, z gathered between
            z = tp.column_parallel(self.TorchConv_0, lambda xc: conv2d_relu(
                xc.contiguous(), w1, b1), x)
            return tp.column_parallel(self.TorchConv_1, lambda zc: conv2d_relu(
                zc.contiguous(), w2, b2), z)
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

