"""Evaluation metrics of the port (the JAX package's ``metrics``: the 2D
eval metrics and the 3D registry)."""

from .metrics2d import (
    compute_dice,
    compute_iou,
    compute_metrics,
    compute_metrics_multiclass,
    dice_coef,
    iou_score,
)
from .metrics3d import get_evaluation_metric

__all__ = ["compute_dice", "compute_iou", "compute_metrics",
           "compute_metrics_multiclass", "dice_coef", "get_evaluation_metric",
           "iou_score"]
