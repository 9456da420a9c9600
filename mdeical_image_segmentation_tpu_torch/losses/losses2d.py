"""2D segmentation losses (the JAX package's ``losses/losses2d.py``).

Each loss takes ``(logits, targets)`` channels-last and applies the sigmoid
itself; the reductions are global over the whole batch, not per sample.
``segmentation_loss`` is UNet-3+'s hybrid F1 + MS-SSIM + IoU; its MS-SSIM
needs images of more than 160 px a side.

Under data parallelism (the batch's rows split over the ranks by
``parallel.rows_split``) the F1 and IoU ratios are ratios of the global
batch's sums: each rank's sums are all-reduced, differentiably, before the
ratio, so every rank's loss is the global one.  MS-SSIM, BCE and CE are
means of per-image or per-element terms: with equal rows on every rank,
DDP's average of the ranks' gradients is already the global mean's.
"""

from __future__ import annotations

import torch

from ..ops.msssim import ms_ssim
from ..parallel.mesh import global_sum


def f1_loss(logits: torch.Tensor, targets: torch.Tensor,
            epsilon: float = 1e-7) -> torch.Tensor:
    """1 − soft F1 over the whole batch."""
    probs = torch.sigmoid(logits)
    tp, sp, st = global_sum(torch.stack(
        [(probs * targets).sum(), probs.sum(), targets.sum()]))
    precision = tp / (sp + epsilon)
    recall = tp / (st + epsilon)
    return 1.0 - 2.0 * precision * recall / (precision + recall + epsilon)


def iou_loss(logits: torch.Tensor, targets: torch.Tensor,
             epsilon: float = 1e-7) -> torch.Tensor:
    """1 − soft IoU over the whole batch."""
    probs = torch.sigmoid(logits)
    intersection, sp, st = global_sum(torch.stack(
        [(probs * targets).sum(), probs.sum(), targets.sum()]))
    union = sp + st - intersection
    return 1.0 - (intersection + epsilon) / (union + epsilon)


def msssim_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """1 − MS-SSIM(sigmoid(logits), targets), data_range 1: a mean over
    images, which needs no all-reduce under data parallelism."""
    return 1.0 - ms_ssim(torch.sigmoid(logits), targets, data_range=1.0)


def segmentation_loss(logits: torch.Tensor, targets: torch.Tensor
                      ) -> torch.Tensor:
    """The hybrid pixel/patch/map-level loss: F1 + MS-SSIM + IoU."""
    return (f1_loss(logits, targets) + msssim_loss(logits, targets)
            + iou_loss(logits, targets))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in the stable form
    max(x, 0) − x·t + log1p(exp(−|x|)) the JAX package writes."""
    x = logits
    loss = x.clamp_min(0.0) - x * targets + torch.log1p(torch.exp(-x.abs()))
    return loss.mean()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean softmax cross-entropy over channels-last logits; ``targets``
    holds integer class ids (N, ...), or (N, H, W, 1) class maps."""
    logp = torch.log_softmax(logits, dim=-1)
    t = targets.to(torch.int64)
    if t.ndim == logits.ndim and t.shape[-1] == 1:
        t = t[..., 0]
    return -torch.gather(logp, -1, t[..., None])[..., 0].mean()
