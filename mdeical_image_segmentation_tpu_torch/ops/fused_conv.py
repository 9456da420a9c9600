"""Fused 2D DoubleConvolution forward: a CUDA kernel and its plain version.

``fused_double2d`` is the counterpart of the JAX package's
``ops/fused_conv.py::fused_double2d`` (a Pallas TPU kernel there, a
hand-written CUDA kernel here, ``csrc/double_conv2d.cu``)::

    z = relu(conv3x3(x, w1) + b1)      rounded to x's dtype
    y = relu(conv3x3(z, w2) + b2)

with stride 1, zero padding 1 and fp32 accumulation, on NHWC activations and
HWIO weights.  It returns ``(y, z)``; ``with_z=False`` returns ``(y, None)``
(the serving path).  On the card the kernel is two launches of the shared
tensor-core conv core (``csrc/conv_tc.cuh``): conv1 writes z to device
memory, conv2 reads it; with ``with_z=False`` z goes to a scratch buffer
that the wrapper allocates and drops.

Dispatch is by the device of ``x`` alone: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs ``fused_double2d_reference``.  There is no
fallback and no switch.  ``fused_double2d.launches`` counts kernel launches:
two per call on the card (conv1, conv2).

``double_conv2d`` is the counterpart of the JAX package's custom-VJP
``double_conv2d`` (``_dc_fwd`` / ``_dc_bwd``), a ``torch.autograd.Function``:
the forward is ``fused_double2d`` with z kept; the backward takes the ReLU
masks from the saved y and z and the convs' input and weight gradients from
the library convolution backward (cuDNN on the card), as the JAX package
takes them from XLA (``jax.linear_transpose``) outside any Pallas kernel.

``fused_conv3d`` is the counterpart of the JAX package's
``ops/fused_conv.py::fused_conv3d`` (the Pallas ``_gcr_kernel`` there,
``csrc/gcr_conv3d.cu`` here, one launch of the same tensor-core core, fp32
as 3xTF32): the SingleConv('gcr') forward with the GroupNorm affine applied
to the input tile in the conv's prologue, so the normalized tensor never
reaches device memory::

    y = relu?(conv3d_{kd x 3 x 3}(relu?(a·x + b)))      kd in {1, 3}

stride 1, torch padding ``((kd-1)//2, 1, 1)`` of the NORMALIZED tensor, no
bias, NDHWC activations and (kd, 3, 3, Ci, Co) weights, a and b (N, Ci)
fp32.  Same dispatch rule; ``.launches`` counts one per call (no split-K
pass: the core picks a smaller tile for small shapes instead).

``gcr_fused_conv`` is the counterpart of the JAX package's custom-VJP
``gcr_fused_conv`` (``_gcr_fwd`` / ``_gcr_bwd``), a
``torch.autograd.Function``.  Forward: the GroupNorm statistics kernel, the
(N, C) affine coefficients, ``fused_conv3d`` with the ReLU.  Backward: the
ReLU mask from the saved output; the normalized input recomputed by the
GroupNorm affine kernel (rounded to x's dtype, as the forward rounds it);
the conv's input and weight gradients from the library convolution backward
(cuDNN on the card), as the JAX package takes them from XLA outside any
Pallas kernel; then the GroupNorm backward kernels (``ops/norm.py``).  The
raw wrappers stay forward only: called directly on a tensor that autograd
would have to differentiate, the CUDA path raises (the CPU path is the
plain composition, which autograd differentiates).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, norm

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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError(
            "fused_double2d: the raw kernel wrapper has no backward; train "
            "through double_conv2d (an autograd Function), or call it under "
            "torch.no_grad/inference_mode")


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
    # conv1's output: returned, or scratch that conv2 reads and we drop
    z = torch.empty((n, h, w, c1), dtype=x.dtype, device=x.device)
    dev = x.get_device()
    rc = _build.kernel("tpuseg_double_conv2d_forward")(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), z.data_ptr(), n, h, w, ci, c1, co,
        _DTYPE_CODES[x.dtype], dev, _build.current_stream(dev),
    )
    _build.check(rc, "double_conv2d launch")
    fused_double2d.launches += 2
    return y, (z if with_z else None)


fused_double2d.launches = 0


def _conv2d_backward(gm: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                     need_dx: bool, need_dw: bool
                     ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Input and weight gradients of the stride-1, padding-1 conv2d of NHWC
    ``x`` with an HWIO 3x3 ``w``, from the library convolution backward;
    returned NHWC and HWIO.  The NCHW views of NHWC tensors are
    channels-last, which cuDNN takes as they are."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        gm.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
        w.permute(3, 2, 0, 1), None, [1, 1], [1, 1], [1, 1], False, [0, 0],
        1, [need_dx, need_dw, False])
    if dx is not None:
        dx = dx.permute(0, 2, 3, 1)
    if dw is not None:
        dw = dw.permute(2, 3, 1, 0)
    return dx, dw


class _DoubleConv2dFn(torch.autograd.Function):
    """relu(conv(relu(conv(x, w1) + b1), w2) + b2) with the JAX package's
    custom VJP: fused forward, no forward recompute in the backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        y, z = fused_double2d(x, w1, b1, w2, b2, with_z=True)
        ctx.save_for_backward(x, z, y, w1, w2)
        return y

    @staticmethod
    def backward(ctx, g):
        x, z, y, w1, w2 = ctx.saved_tensors
        need_x, need_w1, need_b1, need_w2, need_b2 = ctx.needs_input_grad
        # ReLU masks in one pass each (ATen's ReLU backward: g where y > 0,
        # else 0); the bias sums accumulate in fp32 without an fp32 copy
        gm2 = torch.ops.aten.threshold_backward(g.to(z.dtype), y, 0)
        dz, dw2 = _conv2d_backward(gm2, z, w2, True, need_w2)
        db2 = (gm2.sum((0, 1, 2), dtype=torch.float32).to(gm2.dtype)
               if need_b2 else None)
        gm1 = torch.ops.aten.threshold_backward(dz.to(x.dtype), z, 0)
        del dz
        dx, dw1 = _conv2d_backward(gm1, x, w1, need_x, need_w1)
        db1 = (gm1.sum((0, 1, 2), dtype=torch.float32).to(gm1.dtype)
               if need_b1 else None)
        return (dx, None if dw1 is None else dw1.to(w1.dtype), db1,
                None if dw2 is None else dw2.to(w2.dtype), db2)


def double_conv2d(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The DoubleConvolution forward of :func:`fused_double2d` (kernel 1 on
    a CUDA tensor, the plain version on a CPU tensor), differentiable in
    every input: returns y; the backward uses the saved z and y."""
    return _DoubleConv2dFn.apply(x, w1, b1, w2, b2)


def fused_conv3d_reference(
    x: torch.Tensor, kernel: torch.Tensor, pre_scale: torch.Tensor,
    pre_shift: torch.Tensor, *, pre_relu: bool = False,
    post_relu: bool = True,
) -> torch.Tensor:
    """The affine in fp32 rounded to x's dtype, then ``F.conv3d`` in x's
    dtype; same contract as :func:`fused_conv3d`."""
    n, ci = x.shape[0], x.shape[-1]
    shape = (n, 1, 1, 1, ci)
    # one fp32 temporary, updated in place (the 3D UNet's decoder inputs
    # reach 19 GB in fp32)
    xa = x.to(torch.float32, copy=True).mul_(pre_scale.reshape(shape))
    xa.add_(pre_shift.reshape(shape))
    if pre_relu:
        xa.relu_()
    xa = xa.to(x.dtype).permute(0, 4, 1, 2, 3)
    kd = kernel.shape[0]
    y = F.conv3d(xa, kernel.permute(4, 3, 0, 1, 2),
                 padding=((kd - 1) // 2, 1, 1))
    if post_relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _check3d(x, kernel, pre_scale, pre_shift):
    if x.ndim != 5:
        raise ValueError(f"x must be (N, D, H, W, Ci), got {tuple(x.shape)}")
    n, ci = x.shape[0], x.shape[-1]
    if (kernel.ndim != 5 or kernel.shape[0] not in (1, 3)
            or tuple(kernel.shape[1:4]) != (3, 3, ci)):
        raise ValueError(f"kernel must be (1|3, 3, 3, {ci}, Co), got "
                         f"{tuple(kernel.shape)}")
    for name, t in (("x", x), ("kernel", kernel)):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, x is "
                            f"{x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("pre_scale", pre_scale), ("pre_shift", pre_shift)):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (n, ci) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 ({n}, {ci}) "
                             f"on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_conv3d takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("fused_conv3d needs a non-empty x")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, kernel, pre_scale, pre_shift)):
        raise RuntimeError(
            "fused_conv3d: the raw kernel wrapper has no backward; train "
            "through gcr_fused_conv (an autograd Function), or call it under "
            "torch.no_grad/inference_mode")


def fused_conv3d(
    x: torch.Tensor, kernel: torch.Tensor, pre_scale: torch.Tensor,
    pre_shift: torch.Tensor, *, pre_relu: bool = False,
    post_relu: bool = True,
) -> torch.Tensor:
    """``relu?(conv3d(relu?(a·x + b)))``: x (N, D, H, W, Ci) float32 or
    bfloat16, kernel (kd, 3, 3, Ci, Co) in x's dtype, pre_scale/pre_shift
    (N, Ci) fp32; returns y (N, D, H, W, Co) in x's dtype."""
    if x.device.type == "cpu":
        return fused_conv3d_reference(x, kernel, pre_scale, pre_shift,
                                      pre_relu=pre_relu, post_relu=post_relu)
    if not x.is_cuda:
        raise ValueError(f"fused_conv3d runs on cuda or cpu, not {x.device}")
    _check3d(x, kernel, pre_scale, pre_shift)
    n, d, h, w, ci = x.shape
    kd, co = kernel.shape[0], kernel.shape[-1]
    y = torch.empty((n, d, h, w, co), dtype=x.dtype, device=x.device)
    dev = x.get_device()
    rc = _build.kernel("tpuseg_gcr_conv3d_forward")(
        x.data_ptr(), kernel.data_ptr(), pre_scale.data_ptr(),
        pre_shift.data_ptr(), y.data_ptr(), n, d, h, w, ci, co, kd,
        int(pre_relu), int(post_relu), _DTYPE_CODES[x.dtype], dev,
        _build.current_stream(dev),
    )
    _build.check(rc, "gcr_conv3d launch")
    fused_conv3d.launches += 1
    return y


fused_conv3d.launches = 0


def _conv3d_backward(gy: torch.Tensor, x_aff: torch.Tensor,
                     kernel: torch.Tensor, need_dx: bool, need_dw: bool
                     ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Input and weight gradients of the stride-1 'SAME' conv3d of
    channels-last ``x_aff`` with a (kd, 3, 3, Ci, Co) kernel, from the
    library convolution backward; returned channels-last and DHWIO."""
    kd = kernel.shape[0]
    dxa, dw, _ = torch.ops.aten.convolution_backward(
        gy.permute(0, 4, 1, 2, 3), x_aff.permute(0, 4, 1, 2, 3),
        kernel.permute(4, 3, 0, 1, 2), None, [1, 1, 1],
        [(kd - 1) // 2, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
        [need_dx, need_dw, False])
    if dxa is not None:
        dxa = dxa.permute(0, 2, 3, 4, 1).contiguous()
    if dw is not None:
        dw = dw.permute(2, 3, 4, 1, 0)
    return dxa, dw


class _GcrFusedConvFn(torch.autograd.Function):
    """relu(conv3d(group_norm(x))) with the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, kernel, num_groups, eps):
        mean_c, inv_c = norm.group_norm_stats(x, num_groups, eps)
        a, b = norm.gn_affine_coeffs(mean_c, inv_c, gn_scale, gn_bias)
        y = fused_conv3d(x, kernel, a, b, post_relu=True)
        ctx.save_for_backward(x, mean_c, inv_c, gn_scale, gn_bias, kernel, y)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean_c, inv_c, gn_scale, gn_bias, kernel, y = ctx.saved_tensors
        need_x, need_s, need_b, need_w = ctx.needs_input_grad[:4]
        need_gn = need_x or need_s or need_b
        gm = g * (y > 0).to(g.dtype)
        # the exact forward operand: the affine rounded to x's dtype, the
        # padding frame zero after it (the conv pads x_aff itself)
        a, b = norm.gn_affine_coeffs(mean_c, inv_c, gn_scale, gn_bias)
        x_aff = norm.gn_affine(x, a, b)
        dxa, dw = _conv3d_backward(gm.to(x.dtype), x_aff, kernel, need_gn,
                                   need_w)
        del x_aff
        dx = dscale = dbias = None
        if need_gn:
            dx, dscale, dbias = norm.group_norm_backward(
                x, dxa, mean_c, inv_c, gn_scale, ctx.num_groups, need_x)
        return dx, dscale, dbias, dw, None, None


def gcr_fused_conv(x: torch.Tensor, gn_scale: torch.Tensor,
                   gn_bias: torch.Tensor, kernel: torch.Tensor,
                   num_groups: int, eps: float) -> torch.Tensor:
    """``relu(conv3d(group_norm(x)))``, the SingleConv('gcr') block, on a
    contiguous x: the GroupNorm statistics kernel, the (N, C) coefficient
    algebra, then :func:`fused_conv3d` (the normalized tensor is never
    stored).  Differentiable in x, the GroupNorm parameters and the kernel."""
    return _GcrFusedConvFn.apply(x, gn_scale, gn_bias, kernel, num_groups,
                                 eps)
