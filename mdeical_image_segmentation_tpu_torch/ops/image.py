"""Channels-last image ops (the JAX package's ``ops/image.py``; the 2D ops
the classic UNet needs so far).

Inputs are (N, H, W, C).  ``x.permute(0, 3, 1, 2)`` is a channels-last
strided NCHW view, which PyTorch's kernels read without a copy and answer
in the same memory format, so permuting the result back gives a contiguous
NHWC tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int) -> torch.Tensor:
    """``nn.MaxPool2d(window)`` on an NHWC tensor (stride = window, floor
    mode, no padding)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)


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
