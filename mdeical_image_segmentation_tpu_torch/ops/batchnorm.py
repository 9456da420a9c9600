"""BatchNorm with flax's statistics, on channels-last tensors.

flax's ``nn.BatchNorm`` (what the JAX package's ``TorchBatchNorm`` runs)
computes the batch statistics in float32 whatever the input's dtype, with
the fast variance ``max(0, E[x²] − E[x]²)``, normalizes in float32 as
``(x − mean)·rsqrt(var + eps)·scale + bias`` and casts the result to the
input's dtype; its running variance is updated with the *biased* batch
variance (``ra = m·ra + (1 − m)·batch``), where ``nn.BatchNorm2d`` would use
the unbiased one.

``batch_norm_train`` is that forward as an autograd Function: the
normalization is ATen's batch norm fed with these statistics, the backward
ATen's training backward (the gradient flows through the mean and the
variance), so no float32 copy of the activation is kept.  It returns the
statistics beside the output, without gradient, for the caller's
running-statistics update.

Under data parallelism (``parallel/mesh.py``: the batch's rows split over
the ranks by ``rows_split``) the statistics are the global batch's, as the
JAX package's GSPMD program computes them: the forward all-reduces Σx, Σx²
and the count, the backward Σg and Σg·x̂ (the gradient of every rank's
loss reaches the statistics every rank shares).  The scale's and the
bias's gradients stay this rank's sums, which DDP averages.  torch's
``SyncBatchNorm`` is not this: it keeps the unbiased running variance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel import mesh as mesh_lib
from .image import _to_channels_first as _cf
from .image import _to_channels_last as _cl


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of a channels-last tensor, in
    float32 at least, by flax's fast variance.  On the card a bf16 input is
    summed in float32 by the reductions themselves (Σx, and Σx² as a
    squared 2-norm), with no float32 copy of it; the CPU's 2-norm sums
    serially, so there the input is copied to float32 first."""
    dims = tuple(range(x.ndim - 1))
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        n = x.numel() // x.shape[-1]
        mean = torch.sum(x, dims, dtype=torch.float32) / n
        mean2 = torch.linalg.vector_norm(
            x, 2, dims, dtype=torch.float32).square() / n
    else:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x.mean(dims)
        mean2 = (x * x).mean(dims)
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


def global_batch_stats(x: torch.Tensor, mesh: "mesh_lib.DataMesh"
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``batch_stats`` of the global batch whose rows ``mesh``'s ranks
    split, from each rank's float32 Σx and Σx² (one all-reduce), and the
    global count per channel."""
    dims = tuple(range(x.ndim - 1))
    c = x.shape[-1]
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        s = torch.sum(x, dims, dtype=torch.float32)
        s2 = torch.linalg.vector_norm(x, 2, dims,
                                      dtype=torch.float32).square()
    else:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        s, s2 = x.sum(dims), (x * x).sum(dims)
    n = torch.full((1,), x.numel() // c, dtype=s.dtype, device=s.device)
    tot = mesh_lib.all_sum(torch.cat([s, s2, n]), mesh)
    count = tot[-1]
    mean = tot[:c] / count
    return (mean, torch.clamp_min(tot[c:2 * c] / count - mean * mean, 0.0),
            int(count.item()))


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """``(x − mean)·rsqrt(var + eps)·weight + bias`` per channel of a
    channels-last tensor, in float32, returned in x's dtype (autograd sees
    x, weight and bias; mean and var are constants here)."""
    return _cl(torch.batch_norm(_cf(x), weight, bias, mean, var, False, 0.0,
                                eps, True))


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        if mesh is None:
            mean, var = batch_stats(x)
        else:
            mean, var, ctx.count = global_batch_stats(x, mesh)
        invstd = torch.rsqrt(var + eps)
        y = normalize(x, mean, var, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.eps, ctx.mesh = eps, mesh
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        if ctx.mesh is not None:
            dx, dw, db = _global_backward(g, x, weight, mean, invstd,
                                          ctx.count, ctx.mesh)
            return (dx, dw if ctx.needs_input_grad[1] else None,
                    db if ctx.needs_input_grad[2] else None, None, None)
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            _cf(g.to(x.dtype)), _cf(x), weight, None, None, mean, invstd,
            True, ctx.eps, [True, ctx.needs_input_grad[1],
                            ctx.needs_input_grad[2]])
        return _cl(dx), dw, db, None, None


def _global_backward(g, x, weight, mean, invstd, count: int, mesh):
    """The training backward over the global batch: dx from the ranks'
    summed Σg and Σg·x̂ (one all-reduce), this rank's Σg·x̂ and Σg as the
    scale's and bias's gradients, in float32 at least."""
    dims = tuple(range(x.ndim - 1))
    c = x.shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)
    g = g.to(ct)
    xhat = (x.to(ct) - mean) * invstd
    sg, sgx = g.sum(dims), (g * xhat).sum(dims)
    tot = mesh_lib.all_sum(torch.cat([sg, sgx]), mesh) / count
    dx = (g - tot[:c] - xhat * tot[c:]) * (weight.to(ct) * invstd)
    return dx.to(x.dtype), sgx.to(weight.dtype), sg.to(weight.dtype)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5,
                     mesh: Optional["mesh_lib.DataMesh"] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm of a channels-last tensor with flax's
    statistics: ``(y, mean, var)``, y in x's dtype, mean and the biased var
    float32 and without gradient.  ``mesh`` given (its ranks split the
    batch's rows), the statistics and the backward's sums are the global
    batch's."""
    return _BatchNormTrain.apply(x, weight, bias, eps, mesh)
