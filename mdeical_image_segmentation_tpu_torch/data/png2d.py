"""Host-side image helpers of the 2D PNG data path (the JAX package's
``data/png2d.py``; only what serving needs so far)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def nearest_resize(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.INTER_NEAREST-style resize of (H, W[, C]) numpy arrays:
    source index = floor(dst * in/out)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img
    ri = np.minimum((np.arange(oh) * h // oh), h - 1)
    ci = np.minimum((np.arange(ow) * w // ow), w - 1)
    return img[ri][:, ci]
