"""Channels-last image ops (the JAX package's ``ops/image.py``).

Inputs are (N, H, W, C) or (N, D, H, W, C).  ``x.permute(0, 3, 1, 2)`` is a
channels-last strided NCHW view, which PyTorch's kernels read without a
copy and answer in the same memory format, so permuting the result back
gives a contiguous NHWC tensor (likewise for 3D).  The JAX package's
``pairwise`` and ``depth2d`` pool modes are TPU lowerings of the same max
pool and are not carried over.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int) -> torch.Tensor:
    """``nn.MaxPool2d(window)`` on an NHWC tensor (stride = window, floor
    mode, no padding)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)


IntOrSeq = Union[int, Sequence[int]]


def _tuplify(v: IntOrSeq, n: int) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, *range(2, x.ndim), 1)


def max_pool_nd(x: torch.Tensor, window: IntOrSeq,
                stride: Optional[IntOrSeq] = None, *,
                ceil_mode: bool = False) -> torch.Tensor:
    """``nn.MaxPool{2,3}d(window, stride, ceil_mode=ceil_mode)`` on a
    channels-last tensor (no padding; floor mode drops the tail, so a 3D
    UNet level of 117 pools to 58)."""
    nsp = x.ndim - 2
    pool = {2: F.max_pool2d, 3: F.max_pool3d}[nsp]
    win = _tuplify(window, nsp)
    strd = _tuplify(stride if stride is not None else window, nsp)
    y = pool(_to_channels_first(x), win, strd, ceil_mode=ceil_mode)
    return _to_channels_last(y)


def avg_pool_nd(x: torch.Tensor, window: IntOrSeq,
                stride: Optional[IntOrSeq] = None) -> torch.Tensor:
    """``nn.AvgPool{2,3}d(window, stride)`` on a channels-last tensor."""
    nsp = x.ndim - 2
    pool = {2: F.avg_pool2d, 3: F.avg_pool3d}[nsp]
    win = _tuplify(window, nsp)
    strd = _tuplify(stride if stride is not None else window, nsp)
    return _to_channels_last(pool(_to_channels_first(x), win, strd))


def nearest_resize_index(in_size: int, out_size: int) -> torch.Tensor:
    """The nearest-neighbour source index of each output position,
    ``floor(i * in / out)`` in integers (the JAX package's index map; the
    3D UNet's 58 → 117 upsample depends on it)."""
    idx = torch.arange(out_size, dtype=torch.int64) * in_size // out_size
    return torch.clamp(idx, max=in_size - 1)


def interpolate_nearest_nd(x: torch.Tensor,
                           out_spatial: Sequence[int]) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` to ``out_spatial`` on a
    channels-last tensor, one spatial axis at a time."""
    out_spatial = tuple(out_spatial)
    if len(out_spatial) != x.ndim - 2:
        raise ValueError(f"out_spatial {out_spatial} for a {x.ndim}-d tensor")
    for axis, out_size in enumerate(out_spatial, start=1):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        if out_size % in_size == 0:  # integer factor: each index repeated
            x = torch.repeat_interleave(x, out_size // in_size, dim=axis)
        else:
            x = torch.index_select(
                x, axis, nearest_resize_index(in_size, out_size).to(x.device))
    return x


INTERPOLATE_MAX_OUTPUT = 2 ** 31 - 1  # elements per F.interpolate call


@functools.lru_cache(maxsize=256)
def _linear_resize_matrix(in_size: int, out_size: int,
                          align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix of one axis,
    float32, built as the JAX package builds it.

    align_corners=False: source = (i + 0.5)·in/out − 0.5, clamped to the
    input; align_corners=True: source = i·(in − 1)/(out − 1)."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = (i + 0.5) * in_size / out_size - 0.5
            src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


@functools.lru_cache(maxsize=64)
def _resize_matrix_t(in_size: int, out_size: int, align_corners: bool,
                     device: torch.device) -> torch.Tensor:
    """The transposed matrix on ``device``, copied there once (a pageable
    copy in every backward would wait for the card)."""
    return torch.from_numpy(_linear_resize_matrix(
        in_size, out_size, align_corners).T.copy()).to(device)


class _Resize(torch.autograd.Function):
    """Forward: ``F.interpolate`` of the channels-first view, in x's dtype
    (a bf16 input is interpolated in float32 and rounded once).  Backward:
    the transpose of each axis' interpolation matrix applied to the float32
    cotangent, one matmul per axis: a fixed summation order, where
    ``F.interpolate``'s own backward adds into the input's gradient with
    atomics in its dtype (bf16 on the card)."""

    @staticmethod
    def forward(ctx, x, out_spatial, align_corners):
        ctx.in_spatial = tuple(x.shape[1:-1])
        ctx.align_corners = align_corners
        mode = "bilinear" if len(out_spatial) == 2 else "trilinear"
        # the channels-last kernel takes outputs under 2^31 elements (a
        # served batch of 8 at 512² upsamples hd5 to 2.1e9): split the batch
        per = max(1, math.prod(out_spatial) * x.shape[-1])
        ys = [_to_channels_last(F.interpolate(
                  _to_channels_first(part), size=out_spatial, mode=mode,
                  align_corners=align_corners))
              for part in x.split(max(1, INTERPOLATE_MAX_OUTPUT // per))]
        return ys[0] if len(ys) == 1 else torch.cat(ys)

    @staticmethod
    def backward(ctx, g):
        dtype = g.dtype
        g = g.float()
        for axis, in_size in enumerate(ctx.in_spatial, start=1):
            out_size = g.shape[axis]
            if out_size == in_size:
                continue
            mat_t = _resize_matrix_t(in_size, out_size, ctx.align_corners,
                                     g.device)
            lead, trail = g.shape[:axis], g.shape[axis + 1:]
            g = torch.matmul(mat_t, g.reshape(-1, out_size, math.prod(trail)))
            g = g.reshape(*lead, in_size, *trail)
        return g.to(dtype), None, None


def resize_bilinear(x: torch.Tensor, out_spatial: Sequence[int], *,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear (2 spatial dims) or trilinear (3) resize of a channels-last
    tensor to ``out_spatial``.  The JAX package interpolates in float32 and
    casts once; so does this forward (a bf16 value may differ by one ulp
    where the two round a float32 value differently), and its backward
    sums the gradient in float32 in a fixed order (``_Resize``)."""
    out_spatial = tuple(out_spatial)
    if len(out_spatial) not in (2, 3) or len(out_spatial) != x.ndim - 2:
        raise ValueError(f"out_spatial {out_spatial} for a {x.ndim}-d tensor")
    if tuple(x.shape[1:-1]) == out_spatial:
        return x
    return _Resize.apply(x, out_spatial, align_corners)


def upsample_bilinear2d(x: torch.Tensor, scale: int, *,
                        align_corners: bool = False) -> torch.Tensor:
    """``nn.Upsample(scale_factor=scale, mode='bilinear')`` on an NHWC
    tensor."""
    _, h, w, _ = x.shape
    return resize_bilinear(x, (h * scale, w * scale),
                           align_corners=align_corners)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor nearest upsampling of every spatial dim of a
    channels-last tensor."""
    return interpolate_nearest_nd(x, tuple(s * scale for s in x.shape[1:-1]))


def center_crop(x: torch.Tensor, out_spatial: Sequence[int]) -> torch.Tensor:
    """Center-crop the spatial dims of a channels-last tensor.

    Torchvision parity: the crop offset is ``round((in - out) / 2)`` with
    banker's rounding (Python's ``round``); a larger requested size pads with
    zeros, ``(out - in + 1) // 2`` before and the rest after."""
    out_spatial = tuple(out_spatial)
    if len(out_spatial) != x.ndim - 2:
        raise ValueError(f"out_spatial {out_spatial} for a {x.ndim}-d tensor")
    pads = []  # F.pad order: last spatial dim first, (before, after) each
    slices = [slice(None)]
    for in_size, out_size in zip(x.shape[1:-1], out_spatial):
        if out_size > in_size:
            lo = (out_size - in_size + 1) // 2
            pads = [lo, out_size - in_size - lo] + pads
            slices.append(slice(None))
        else:
            off = int(round((in_size - out_size) / 2.0))
            pads = [0, 0] + pads
            slices.append(slice(off, off + out_size))
    slices.append(slice(None))
    if any(pads):
        x = F.pad(x, [0, 0] + pads)  # channels (last dim) unpadded
    return x[tuple(slices)]
