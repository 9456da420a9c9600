"""Instance-segmentation metrics of the DSB2018 kind (the JAX package's
``metrics/seg_metrics.py``), host numpy on integer label volumes.

The pairwise IoU table between ground-truth and predicted instances comes
from one contingency table of the relabelled volumes; each IoU threshold's
true positives, false positives and false negatives are boolean reductions
over it, and give precision, recall, accuracy and F1.  ``Accuracy`` is
TP / (TP + FP + FN) at one threshold, ``AveragePrecision`` its mean over
IoU 0.50:0.05:0.95.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .seg_compat import contingency_table


def _compact_labels(vol: np.ndarray) -> np.ndarray:
    """The label values mapped onto 0..K-1 (order kept, background first)."""
    _, dense = np.unique(vol, return_inverse=True)
    return dense.reshape(vol.shape)


def _pairwise_iou(gt: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """(K_gt, K_seg) IoU between every ground-truth / predicted pair."""
    overlap = contingency_table(_compact_labels(gt), _compact_labels(seg))
    gt_sizes = overlap.sum(axis=1, keepdims=True)
    seg_sizes = overlap.sum(axis=0, keepdims=True)
    iou = overlap / (gt_sizes + seg_sizes - overlap)
    if not (0.0 <= iou.min() and iou.max() <= 1.0):
        raise AssertionError("IoU table out of [0, 1] — corrupt label input")
    return iou


def _detection_counts(iou_fg: np.ndarray, iou_threshold: float):
    """(tp, fp, fn) at one threshold from the foreground-only IoU table.

    A ground-truth instance is found when some prediction overlaps it above
    the threshold; a prediction that finds none is a false positive.  A
    table with no instance on a side, or no hit at all, counts zeros."""
    hits = iou_fg > iou_threshold
    if hits.size == 0 or not hits.any():
        return 0, 0, 0
    tp = int(hits.any(axis=1).sum())
    fn = iou_fg.shape[0] - tp
    fp = iou_fg.shape[1] - int(hits.any(axis=0).sum())
    return tp, fp, fn


def _rates(tp: int, fp: int, fn: int) -> Dict[str, float]:
    if tp == 0:
        return {"precision": 0, "recall": 0, "accuracy": 0, "f1": 0}
    return {
        "precision": tp / (tp + fp),
        "recall": tp / (tp + fn),
        "accuracy": tp / (tp + fp + fn),
        "f1": (2 * tp) / (2 * tp + fp + fn),
    }


def precision(tp, fp, fn):
    return tp / (tp + fp) if tp > 0 else 0


def recall(tp, fp, fn):
    return tp / (tp + fn) if tp > 0 else 0


def accuracy(tp, fp, fn):
    return tp / (tp + fp + fn) if tp > 0 else 0


def f1(tp, fp, fn):
    return (2 * tp) / (2 * tp + fp + fn) if tp > 0 else 0


class SegmentationMetrics:
    """Precision, recall, accuracy and F1 between ground-truth and predicted
    instances at an IoU threshold; the IoU table is built once."""

    def __init__(self, gt, seg):
        self.iou_matrix = _pairwise_iou(gt, seg)

    def metrics(self, iou_threshold) -> Dict[str, float]:
        # the background row and column (label 0) are not matched
        tp, fp, fn = _detection_counts(self.iou_matrix[1:, 1:], iou_threshold)
        return _rates(tp, fp, fn)


class Accuracy:
    """DSB accuracy TP / (TP + FP + FN) at one IoU threshold."""

    def __init__(self, iou_threshold):
        self.iou_threshold = iou_threshold

    def __call__(self, input_seg, gt_seg):
        return SegmentationMetrics(gt_seg, input_seg).metrics(
            self.iou_threshold)["accuracy"]


class AveragePrecision:
    """Mean DSB accuracy over the IoU thresholds 0.50:0.05:0.95."""

    def __init__(self):
        self.iou_range = np.linspace(0.50, 0.95, 10)

    def __call__(self, input_seg, gt_seg):
        sm = SegmentationMetrics(gt_seg, input_seg)
        return np.mean([sm.metrics(t)["accuracy"] for t in self.iou_range])
