"""2D eval metrics (the JAX package's ``metrics/metrics2d.py``).

``compute_metrics`` keeps the reference eval contract and its quirks, which
matter for score parity:

- the sigmoid is ``1 / (1 + exp(-x) + eps)``;
- the binarization threshold is the **mean of the sigmoided predictions**,
  not a fixed 0.5 (a fixed one is available through ``threshold=``);
- the Dice denominator carries the doubled epsilon;
- a pred-vs-label PNG of the first sample is written when ``plot_path`` is
  set.

The host functions take numpy, channels-last (N, H, W, 1) or (N, H, W).
The device functions take torch tensors on any device and return 0-d
tensors, so the trainer sums them there and reads them once:
``iou`` / ``dice`` (the JAX ``iou_jax`` / ``dice_jax``), ``quirky_sigmoid``,
``pred_mean_sum``, ``iou_dice_sums`` and ``multiclass_iou_dice_sums`` (with
the ``n_valid`` mask that drops a wrap-padded tail).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..utils import png


def _squeeze_channel(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        if a.shape[-1] != 1 and a.shape[1] != 1:
            raise ValueError(f"expected one channel, got {a.shape}")
        a = a[..., 0] if a.shape[-1] == 1 else a[:, 0]
    return a


def compute_iou(preds: np.ndarray, labels: np.ndarray,
                threshold: float = 0.5) -> float:
    """Mean per-sample IoU after thresholding."""
    p = (preds > threshold).astype(np.float32)
    l = (labels > threshold).astype(np.float32)
    intersection = np.sum(p * l, axis=(1, 2))
    union = np.sum(p, axis=(1, 2)) + np.sum(l, axis=(1, 2)) - intersection
    union = np.maximum(union, 1e-6)
    return float(np.mean(intersection / union))


def compute_dice(preds: np.ndarray, labels: np.ndarray,
                 threshold: float = 0.5) -> float:
    """Mean per-sample Dice after thresholding, epsilon placement kept:
    (2∩+ε)/(Σp+Σl+2ε)."""
    p = (preds > threshold).astype(np.float32)
    l = (labels > threshold).astype(np.float32)
    intersection = np.sum(p * l, axis=(1, 2))
    sum_pred = np.sum(p, axis=(1, 2)) + 1e-6
    sum_lab = np.sum(l, axis=(1, 2)) + 1e-6
    dice = (2.0 * intersection + 1e-6) / (sum_pred + sum_lab)
    return float(np.mean(dice))


def iou_score(output: np.ndarray, target: np.ndarray) -> Tuple[float, float]:
    """Global binary IoU at 0.5 on the sigmoided output, and the Dice
    derived from it."""
    output = 1.0 / (1.0 + np.exp(-output))
    o = output > 0.5
    t = target > 0.5
    smooth = 1e-5
    intersection = np.logical_and(o, t).sum()
    union = np.logical_or(o, t).sum()
    iou = (intersection + smooth) / (union + smooth)
    return float(iou), float(2 * iou / (iou + 1))


def dice_coef(output: np.ndarray, target: np.ndarray) -> float:
    """Global soft Dice on the sigmoided output."""
    output = 1.0 / (1.0 + np.exp(-output))
    o = output.reshape(-1)
    t = target.reshape(-1)
    smooth = 1e-5
    intersection = (o * t).sum()
    return float((2.0 * intersection + smooth) / (o.sum() + t.sum() + smooth))


def plot_first_element(array1: np.ndarray, array2: np.ndarray,
                       threshold: float = 0.5,
                       save_path: Optional[str] = "output.png") -> None:
    """Sample 0 of each array thresholded, side by side (array 1 left,
    array 2 right, black and white), written as a PNG by the port's own
    encoder: the JAX package's two-panel figure without matplotlib."""
    a1 = np.asarray(array1)[0] > threshold
    a2 = np.asarray(array2)[0] > threshold
    if save_path is None:
        return
    gap = np.zeros((a1.shape[0], 8), bool)
    panel = np.concatenate([a1, gap, a2], axis=1)
    png.write(save_path, panel.astype(np.uint8) * 255)


def compute_metrics(logits: np.ndarray, labels: np.ndarray, *,
                    threshold: Optional[float] = None,
                    plot_path: Optional[str] = None) -> Dict[str, float]:
    """Eval-loop metrics.  ``threshold=None`` uses the reference's dynamic
    mean-of-sigmoided-preds threshold; pass 0.5 for a fixed one."""
    preds = _squeeze_channel(np.asarray(logits)).astype(np.float32)
    labs = _squeeze_channel(np.asarray(labels)).astype(np.float32)
    preds = 1.0 / (1.0 + np.exp(-preds) + 1e-6)  # epsilon inside, kept
    thr = float(np.mean(preds)) if threshold is None else threshold
    if plot_path is not None:
        plot_first_element(preds, labs, threshold=thr, save_path=plot_path)
    return {"iou": compute_iou(preds, labs, threshold=thr),
            "dice": compute_dice(preds, labs, threshold=thr)}


def compute_metrics_multiclass(logits: np.ndarray, labels: np.ndarray
                               ) -> Dict[str, float]:
    """Host-side multi-class eval: mean per-sample macro IoU/Dice over
    argmax class maps (the math of ``multiclass_iou_dice_sums``)."""
    logits = torch.from_numpy(np.asarray(logits, np.float32))
    n = logits.shape[0]
    isum, dsum = multiclass_iou_dice_sums(
        logits, torch.from_numpy(np.asarray(labels)), n)
    return {"iou": float(isum) / n, "dice": float(dsum) / n}


# -- device variants -----------------------------------------------------------

Count = Union[int, torch.Tensor]


def quirky_sigmoid(logits: torch.Tensor) -> torch.Tensor:
    """The reference's sigmoid with epsilon inside the denominator."""
    return 1.0 / (1.0 + torch.exp(-logits) + 1e-6)


def _thresholded(logits, labels, threshold):
    preds = quirky_sigmoid(logits)
    thr = preds.mean() if threshold is None else threshold
    axes = tuple(range(1, preds.ndim))
    p = (preds > thr).float()
    l = (labels.float() > thr).float()
    return p, l, (p * l).sum(axes), axes


def iou(logits: torch.Tensor, labels: torch.Tensor,
        threshold=None) -> torch.Tensor:
    """Mean per-sample IoU with the dynamic-threshold semantics when
    ``threshold`` is None (the JAX ``iou_jax``)."""
    p, l, inter, axes = _thresholded(logits, labels, threshold)
    union = (p.sum(axes) + l.sum(axes) - inter).clamp_min(1e-6)
    return (inter / union).mean()


def dice(logits: torch.Tensor, labels: torch.Tensor,
         threshold=None) -> torch.Tensor:
    """Mean per-sample Dice, as ``iou`` (the JAX ``dice_jax``)."""
    p, l, inter, axes = _thresholded(logits, labels, threshold)
    denom = p.sum(axes) + l.sum(axes) + 2e-6
    return ((2.0 * inter + 1e-6) / denom).mean()


def _valid_mask(n_total: int, n_valid: Count, device) -> torch.Tensor:
    return (torch.arange(n_total, device=device) < n_valid).float()


def pred_mean_sum(logits: torch.Tensor, n_valid: Count) -> torch.Tensor:
    """Sum over the first ``n_valid`` samples of each sample's mean
    sigmoided prediction; the total over an eval set divided by Σ n_valid is
    the reference's dynamic threshold (equal pixel counts per sample)."""
    preds = quirky_sigmoid(logits.float())
    per_sample = preds.mean(tuple(range(1, preds.ndim)))
    return (per_sample * _valid_mask(preds.shape[0], n_valid,
                                     preds.device)).sum()


def iou_dice_sums(logits: torch.Tensor, labels: torch.Tensor, threshold,
                  n_valid: Count) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ per-sample IoU, Σ per-sample Dice) over the first ``n_valid``
    samples, with compute_iou/compute_dice's epsilon placement."""
    preds = quirky_sigmoid(logits.float())
    axes = tuple(range(1, preds.ndim))
    p = (preds > threshold).float()
    l = (labels.float() > threshold).float()
    inter = (p * l).sum(axes)
    union = (p.sum(axes) + l.sum(axes) - inter).clamp_min(1e-6)
    iou_ = inter / union
    dice_ = (2.0 * inter + 1e-6) / (p.sum(axes) + 1e-6 + l.sum(axes) + 1e-6)
    mask = _valid_mask(preds.shape[0], n_valid, preds.device)
    return (iou_ * mask).sum(), (dice_ * mask).sum()


def multiclass_iou_dice_sums(logits: torch.Tensor, labels: torch.Tensor,
                             n_valid: Count
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ per-sample macro IoU, Σ per-sample macro Dice) for C > 1 heads:
    argmax class maps, each class a binary IoU/Dice with compute_iou /
    compute_dice's epsilons, averaged over the classes (background
    included) per sample."""
    n, n_classes = logits.shape[0], logits.shape[-1]
    pred_cls = torch.argmax(logits, dim=-1)
    labs = labels
    if labs.ndim == pred_cls.ndim + 1 and labs.shape[-1] == 1:
        labs = labs[..., 0]
    labs = labs.to(torch.int64)
    classes = torch.arange(n_classes, device=logits.device).view(
        -1, *([1] * pred_cls.ndim))
    p = (pred_cls[None] == classes).float()  # (C, N, H, W)
    l = (labs[None] == classes).float()
    axes = tuple(range(2, p.ndim))
    inter = (p * l).sum(axes)
    union = (p.sum(axes) + l.sum(axes) - inter).clamp_min(1e-6)
    iou_ = (inter / union).mean(0)
    dice_ = ((2.0 * inter + 1e-6)
             / (p.sum(axes) + 1e-6 + l.sum(axes) + 1e-6)).mean(0)
    mask = _valid_mask(n, n_valid, logits.device)
    return (iou_ * mask).sum(), (dice_ * mask).sum()
