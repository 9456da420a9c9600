"""Channels-last image ops (the JAX package's ``ops/image.py``; the ops the
classic UNet and the 3D UNet family need so far).

Inputs are (N, H, W, C) or (N, D, H, W, C).  ``x.permute(0, 3, 1, 2)`` is a
channels-last strided NCHW view, which PyTorch's kernels read without a
copy and answer in the same memory format, so permuting the result back
gives a contiguous NHWC tensor (likewise for 3D).  The JAX package's
``pairwise`` and ``depth2d`` pool modes are TPU lowerings of the same max
pool and are not carried over.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

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
