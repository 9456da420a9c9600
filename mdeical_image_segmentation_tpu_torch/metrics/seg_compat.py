"""scikit-image's segmentation metrics in numpy (the JAX package's
``metrics/seg_compat.py``; the machine with the card has no skimage):

- ``contingency_table(im_true, im_test)``: dense co-occurrence counts
  (skimage's is sparse), with ``ignore_labels`` dropping pixels by their
  true label;
- ``adapted_rand_error``: the SNEMI3D Adapted Rand error in skimage's
  pairs-counting form (sums of squares minus the n diagonal terms),
  returning (are, precision, recall);
- ``peak_signal_noise_ratio`` / ``mean_squared_error``: skimage's
  conventions (a float image is taken in [-1, 1], data_range 2, or in
  [0, 1], data_range 1, when it is non-negative; an integer image spans its
  dtype's range).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def contingency_table(im_true: np.ndarray, im_test: np.ndarray, *,
                      ignore_labels: Sequence[int] = (),
                      normalize: bool = False) -> np.ndarray:
    """Dense (n_true_labels, n_test_labels) co-occurrence counts, indexed by
    the sorted unique labels of each image."""
    true_flat = im_true.ravel()
    test_flat = im_test.ravel()
    if ignore_labels:
        keep = ~np.isin(true_flat, ignore_labels)
        true_flat = true_flat[keep]
        test_flat = test_flat[keep]
    true_labels, true_idx = np.unique(true_flat, return_inverse=True)
    test_labels, test_idx = np.unique(test_flat, return_inverse=True)
    n_true, n_test = len(true_labels), len(test_labels)
    counts = np.bincount(
        true_idx * n_test + test_idx, minlength=n_true * n_test
    ).reshape(n_true, n_test).astype(np.float64)
    if normalize:
        counts /= counts.sum()
    return counts


def adapted_rand_error(image_true: np.ndarray, image_test: np.ndarray, *,
                       ignore_labels: Sequence[int] = (0,),
                       alpha: float = 0.5) -> Tuple[float, float, float]:
    """SNEMI3D Adapted Rand error: (are, precision, recall).

    With contingency counts p_ij, row sums a_i and column sums b_j over the
    pixels not ignored: sum_p2 = Σ p_ij² − n, sum_a2 = Σ a_i² − n,
    sum_b2 = Σ b_j² − n; precision = sum_p2 / sum_b2, recall = sum_p2 /
    sum_a2, are = 1 − sum_p2 / (α·sum_a2 + (1 − α)·sum_b2).
    """
    if not 0.0 <= alpha <= 1.0:
        raise ValueError("alpha must be in [0, 1]")
    p_ij = contingency_table(image_true, image_test,
                             ignore_labels=ignore_labels, normalize=False)
    n = p_ij.sum()
    sum_p2 = float((p_ij * p_ij).sum() - n)
    a_i = p_ij.sum(axis=1)
    b_j = p_ij.sum(axis=0)
    sum_a2 = float(a_i @ a_i - n)
    sum_b2 = float(b_j @ b_j - n)
    precision = sum_p2 / sum_b2 if sum_b2 > 0 else 0.0
    recall = sum_p2 / sum_a2 if sum_a2 > 0 else 0.0
    denom = alpha * sum_a2 + (1.0 - alpha) * sum_b2
    fscore = sum_p2 / denom if denom > 0 else 0.0
    return 1.0 - fscore, precision, recall


def _data_range(image_true: np.ndarray) -> float:
    if np.issubdtype(image_true.dtype, np.integer):
        info = np.iinfo(image_true.dtype)
        return float(info.max) - float(info.min)
    # float images: the (-1, 1) range, or (0, 1) when non-negative
    return 2.0 if image_true.min() < 0 else 1.0


def peak_signal_noise_ratio(image_true: np.ndarray, image_test: np.ndarray,
                            *, data_range: Optional[float] = None) -> float:
    if data_range is None:
        data_range = _data_range(image_true)
    err = mean_squared_error(image_true, image_test)
    if err == 0:
        return float("inf")
    return float(10 * np.log10((data_range ** 2) / err))


def mean_squared_error(image0: np.ndarray, image1: np.ndarray) -> float:
    image0 = np.asarray(image0, dtype=np.float64)
    image1 = np.asarray(image1, dtype=np.float64)
    return float(np.mean((image0 - image1) ** 2))
