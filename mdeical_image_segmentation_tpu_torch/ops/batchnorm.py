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
"""

from __future__ import annotations

from typing import Tuple

import torch

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
    def forward(ctx, x, weight, bias, eps):
        mean, var = batch_stats(x)
        invstd = torch.rsqrt(var + eps)
        y = normalize(x, mean, var, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            _cf(g.to(x.dtype)), _cf(x), weight, None, None, mean, invstd,
            True, ctx.eps, [True, ctx.needs_input_grad[1],
                            ctx.needs_input_grad[2]])
        return _cl(dx), dw, db, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm of a channels-last tensor with flax's
    statistics: ``(y, mean, var)``, y in x's dtype, mean and the biased var
    float32 and without gradient."""
    return _BatchNormTrain.apply(x, weight, bias, eps)
