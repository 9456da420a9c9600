"""2D segmentation losses (the JAX package's ``losses/losses2d.py``).

Each loss takes ``(logits, targets)`` channels-last and applies the sigmoid
itself; the reductions are global over the whole batch, not per sample.
The hybrid UNet-3+ loss (MS-SSIM + F1 + IoU) waits for its slice.
"""

from __future__ import annotations

import torch

HYBRID_ITEM = "ROADMAP.md queue 1, item 14 (hybrid loss and MS-SSIM)"


def f1_loss(logits: torch.Tensor, targets: torch.Tensor,
            epsilon: float = 1e-7) -> torch.Tensor:
    """1 − soft F1 over the whole batch."""
    probs = torch.sigmoid(logits)
    tp = (probs * targets).sum()
    precision = tp / (probs.sum() + epsilon)
    recall = tp / (targets.sum() + epsilon)
    return 1.0 - 2.0 * precision * recall / (precision + recall + epsilon)


def iou_loss(logits: torch.Tensor, targets: torch.Tensor,
             epsilon: float = 1e-7) -> torch.Tensor:
    """1 − soft IoU over the whole batch."""
    probs = torch.sigmoid(logits)
    intersection = (probs * targets).sum()
    union = probs.sum() + targets.sum() - intersection
    return 1.0 - (intersection + epsilon) / (union + epsilon)


def msssim_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(f"msssim_loss is not ported yet ({HYBRID_ITEM})")


def segmentation_loss(logits: torch.Tensor, targets: torch.Tensor
                      ) -> torch.Tensor:
    raise NotImplementedError(
        f"segmentation_loss (F1 + MS-SSIM + IoU) is not ported yet "
        f"({HYBRID_ITEM})")


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
