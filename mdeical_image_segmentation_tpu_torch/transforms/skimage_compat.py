"""The three scikit-image primitives the volume transforms use, on
scipy.ndimage (the JAX package's ``transforms/skimage_compat.py``):

- ``label``: connected components of equal-valued regions, per value with a
  shared running label counter; full connectivity by default, as skimage's;
- ``find_boundaries``: grey dilation != grey erosion over the connectivity
  footprint; 'inner' keeps foreground pixels, 'outer' background pixels
  next to a (full-connectivity) object;
- ``gaussian``: skimage.filters.gaussian ('nearest' border, integer images
  rescaled to [0, 1] first).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
from scipy import ndimage


def label(
    input: np.ndarray,
    background: Optional[int] = 0,
    return_num: bool = False,
    connectivity: Optional[int] = None,
) -> Union[np.ndarray, Tuple[np.ndarray, int]]:
    """Connected-component labeling of equal-valued regions.

    Two pixels connect when they are neighbors (within `connectivity`,
    default full) and share the same value; `background`-valued pixels get 0.
    """
    if background is None:
        background = 0
    ndim = input.ndim
    if connectivity is None:
        connectivity = ndim
    structure = ndimage.generate_binary_structure(ndim, connectivity)
    out = np.zeros(input.shape, dtype=np.int64)
    next_label = 0
    for v in np.unique(input):
        if v == background:
            continue
        mask = input == v
        lab, n = ndimage.label(mask, structure=structure)
        out[mask] = lab[mask] + next_label
        next_label += n
    if return_num:
        return out, next_label
    return out


def find_boundaries(
    label_img: np.ndarray,
    connectivity: int = 1,
    mode: str = "thick",
    background: int = 0,
) -> np.ndarray:
    """Boundaries between labeled regions (bool mask).

    - 'thick': any pixel whose neighborhood (connectivity footprint) spans
      more than one value;
    - 'inner': thick boundaries restricted to non-background pixels;
    - 'outer': background pixels adjacent to an object (full connectivity,
      ties between touching objects handled via the max-label trick).
    """
    if label_img.dtype == bool:
        label_img = label_img.astype(np.uint8)
    ndim = label_img.ndim
    footprint = ndimage.generate_binary_structure(ndim, connectivity)
    boundaries = ndimage.grey_dilation(
        label_img, footprint=footprint
    ) != ndimage.grey_erosion(label_img, footprint=footprint)
    if mode == "thick":
        return boundaries
    if mode == "inner":
        return boundaries & (label_img != background)
    if mode == "outer":
        max_label = np.iinfo(label_img.dtype).max if np.issubdtype(
            label_img.dtype, np.integer
        ) else np.int64(np.max(label_img) + 1)
        background_image = label_img == background
        full_fp = ndimage.generate_binary_structure(ndim, ndim)
        inverted = np.array(label_img, copy=True)
        inverted[background_image] = max_label
        adjacent_to_object = (
            ndimage.grey_erosion(inverted, footprint=full_fp) != max_label
        )
        return boundaries & background_image & adjacent_to_object
    raise ValueError(f"unsupported find_boundaries mode {mode!r}")


def gaussian(image: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """Gaussian blur with skimage.filters.gaussian semantics ('nearest'
    border mode), INCLUDING its img_as_float input conversion: integer
    images are rescaled to [0, 1] by their dtype range before filtering
    (a uint8 volume comes back in [0, 1], not [0, 255]) — matching what the
    GaussianBlur3D sees from skimage."""
    image = np.asarray(image)
    if np.issubdtype(image.dtype, np.integer):
        # img_as_float: unsigned → [0, 1], signed → [-1, 1], both by
        # dividing by the dtype's positive max
        img = image.astype(np.float64) / np.iinfo(image.dtype).max
    else:
        img = image.astype(np.float64)
    return ndimage.gaussian_filter(img, sigma=sigma, mode="nearest")
