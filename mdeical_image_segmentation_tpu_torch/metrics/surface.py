"""Surface-distance and overlap metrics of binary masks (the JAX package's
``metrics/surface.py``): Dice, Jaccard, HD95, ASD and ASSD with medpy's
definitions, on ``scipy.ndimage``.

- The surface of a mask: its voxels that one binary erosion with the
  connectivity-1 structuring element removes.
- One-directional surface distances: the Euclidean distance transform of
  the complement of the reference's surface, read at the result's surface.
- ``hd95``: the 95th percentile of both directions' distances pooled;
  ``asd``: the mean result → reference; ``assd``: the mean of both means.
- An empty result or reference has no surface: the distances raise
  ``RuntimeError``; ``dc`` and ``jc`` of two empty masks are 0.

Host numpy: these run on final masks, not in the train loop.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def _surface_distances(result: np.ndarray, reference: np.ndarray,
                       voxelspacing=None) -> np.ndarray:
    result = np.atleast_1d(result.astype(bool))
    reference = np.atleast_1d(reference.astype(bool))
    if not result.any():
        raise RuntimeError("the result array is empty; surface distance "
                           "undefined")
    if not reference.any():
        raise RuntimeError("the reference array is empty; surface distance "
                           "undefined")
    footprint = ndimage.generate_binary_structure(result.ndim, 1)
    result_border = result ^ ndimage.binary_erosion(
        result, structure=footprint, iterations=1)
    reference_border = reference ^ ndimage.binary_erosion(
        reference, structure=footprint, iterations=1)
    dt = ndimage.distance_transform_edt(~reference_border,
                                        sampling=voxelspacing)
    return dt[result_border]


def hd95(result: np.ndarray, reference: np.ndarray,
         voxelspacing=None) -> float:
    """The 95th percentile of the symmetric surface distances."""
    hd1 = _surface_distances(result, reference, voxelspacing)
    hd2 = _surface_distances(reference, result, voxelspacing)
    return float(np.percentile(np.hstack((hd1, hd2)), 95))


def asd(result: np.ndarray, reference: np.ndarray,
        voxelspacing=None) -> float:
    """The average surface distance, result → reference."""
    return float(_surface_distances(result, reference, voxelspacing).mean())


def assd(result: np.ndarray, reference: np.ndarray,
         voxelspacing=None) -> float:
    """The average symmetric surface distance."""
    return float(np.mean((
        _surface_distances(result, reference, voxelspacing).mean(),
        _surface_distances(reference, result, voxelspacing).mean())))


def dc(result: np.ndarray, reference: np.ndarray) -> float:
    """The binary Dice coefficient."""
    r = result.astype(bool)
    g = reference.astype(bool)
    intersection = np.count_nonzero(r & g)
    size_sum = np.count_nonzero(r) + np.count_nonzero(g)
    return 2.0 * intersection / size_sum if size_sum > 0 else 0.0


def jc(result: np.ndarray, reference: np.ndarray) -> float:
    """The binary Jaccard coefficient."""
    r = result.astype(bool)
    g = reference.astype(bool)
    union = np.count_nonzero(r | g)
    return float(np.count_nonzero(r & g) / union) if union > 0 else 0.0


def calculate_metric_percase(pred: np.ndarray, gt: np.ndarray
                             ) -> Tuple[float, float, float, float]:
    """(dice, jaccard, hd95, asd) of one case."""
    return dc(pred, gt), jc(pred, gt), hd95(pred, gt), asd(pred, gt)
