"""Fused 2D DoubleConvolution forward: a CUDA kernel and its plain version.

``fused_double2d`` is the counterpart of the JAX package's
``ops/fused_conv.py::fused_double2d`` (a Pallas TPU kernel there, a
hand-written CUDA kernel here, ``csrc/double_conv2d.cu``)::

    z = relu(conv3x3(x, w1) + b1)      rounded to x's dtype
    y = relu(conv3x3(z, w2) + b2)

with stride 1, zero padding 1 and fp32 accumulation, on NHWC activations and
HWIO weights.  It returns ``(y, z)``; ``with_z=False`` returns ``(y, None)``
and the kernel then never writes z to device memory (the serving path).

Dispatch is by the device of ``x`` alone: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs ``fused_double2d_reference``.  There is no
fallback and no switch.  ``fused_double2d.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_double2d_reference(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
    b2: torch.Tensor, *, with_z: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Two ``F.conv2d`` + bias + relu in x's dtype; same contract as
    :func:`fused_double2d`."""
    xc = x.permute(0, 3, 1, 2)  # channels-last strided NCHW view, no copy
    z = F.relu(F.conv2d(xc, w1.permute(3, 2, 0, 1), b1, padding=1))
    y = F.relu(F.conv2d(z, w2.permute(3, 2, 0, 1), b2, padding=1))
    y = y.permute(0, 2, 3, 1).contiguous()
    return y, (z.permute(0, 2, 3, 1).contiguous() if with_z else None)


def _check(x, w1, b1, w2, b2):
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, Ci), got {tuple(x.shape)}")
    n, h, w, ci = x.shape
    c1, co = w1.shape[-1], w2.shape[-1]
    want = {"w1": (3, 3, ci, c1), "b1": (c1,), "w2": (3, 3, c1, co),
            "b2": (co,)}
    for name, t in zip(want, (w1, b1, w2, b2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} must be {want[name]} for x {tuple(x.shape)}, "
                f"got {tuple(t.shape)}")
    for name, t in zip(("x", "w1", "b1", "w2", "b2"), (x, w1, b1, w2, b2)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_double2d takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("fused_double2d needs a non-empty x")


def fused_double2d(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
    b2: torch.Tensor, *, with_z: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The classic-UNet DoubleConvolution forward.  x (N, H, W, Ci), w1
    (3, 3, Ci, C1), b1 (C1,), w2 (3, 3, C1, Co), b2 (Co,), one dtype
    (float32 or bfloat16); returns y (N, H, W, Co) and z (N, H, W, C1)."""
    if x.device.type == "cpu":
        return fused_double2d_reference(x, w1, b1, w2, b2, with_z=with_z)
    if not x.is_cuda:
        raise ValueError(f"fused_double2d runs on cuda or cpu, not {x.device}")
    _check(x, w1, b1, w2, b2)
    n, h, w, ci = x.shape
    c1, co = w1.shape[-1], w2.shape[-1]
    y = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    z = (torch.empty((n, h, w, c1), dtype=x.dtype, device=x.device)
         if with_z else None)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.tpuseg_double_conv2d_forward(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), z.data_ptr() if z is not None else None,
        n, h, w, ci, c1, co, _DTYPE_CODES[x.dtype], x.device.index, stream,
    )
    _build.check(lib, rc, "double_conv2d launch")
    fused_double2d.launches += 1
    return y, z


fused_double2d.launches = 0
