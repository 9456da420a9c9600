"""Evaluation metrics of the port (the JAX package's ``metrics``): the 2D
eval metrics, the 3D registry with its instance metrics, the surface
metrics and the scikit-image and DSB segmentation metrics they use."""

from .metrics2d import (
    compute_dice,
    compute_iou,
    compute_metrics,
    compute_metrics_multiclass,
    dice_coef,
    iou_score,
)
from .metrics3d import (
    EVAL_METRICS,
    MSE,
    PSNR,
    AdaptedRandError,
    BlobsAveragePrecision,
    BlobsBoundaryAveragePrecision,
    BoundaryAdaptedRandError,
    BoundaryAveragePrecision,
    DiceCoefficient,
    GenericAdaptedRandError,
    GenericAveragePrecision,
    MeanIoU,
    convert_to_numpy,
    get_evaluation_metric,
)
from .seg_compat import (
    adapted_rand_error,
    contingency_table,
    mean_squared_error,
    peak_signal_noise_ratio,
)
from .seg_metrics import Accuracy, AveragePrecision, SegmentationMetrics
from .surface import asd, assd, calculate_metric_percase, dc, hd95, jc

__all__ = [
    "compute_dice", "compute_iou", "compute_metrics",
    "compute_metrics_multiclass", "dice_coef", "iou_score",
    "asd", "assd", "calculate_metric_percase", "dc", "hd95", "jc",
    "EVAL_METRICS", "AdaptedRandError", "BlobsAveragePrecision",
    "BlobsBoundaryAveragePrecision", "BoundaryAdaptedRandError",
    "BoundaryAveragePrecision", "DiceCoefficient", "GenericAdaptedRandError",
    "GenericAveragePrecision", "MSE", "MeanIoU", "PSNR", "convert_to_numpy",
    "get_evaluation_metric",
    "Accuracy", "AveragePrecision", "SegmentationMetrics",
    "adapted_rand_error", "contingency_table", "mean_squared_error",
    "peak_signal_noise_ratio",
]
