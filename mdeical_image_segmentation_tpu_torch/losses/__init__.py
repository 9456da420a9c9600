"""Losses of the port (the JAX package's ``losses``: the 2D losses and the
3D registry)."""

from .losses2d import (
    bce_with_logits,
    cross_entropy,
    f1_loss,
    iou_loss,
    msssim_loss,
    segmentation_loss,
)
from .losses3d import get_loss_criterion

__all__ = ["bce_with_logits", "cross_entropy", "f1_loss",
           "get_loss_criterion", "iou_loss", "msssim_loss",
           "segmentation_loss"]
