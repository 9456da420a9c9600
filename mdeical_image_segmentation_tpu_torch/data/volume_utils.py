"""Volume helpers (the JAX package's ``data/volume_utils.py``): global
stats, halo mirror padding, padded patch indexes, HDF5 path traversal; and
``padded_patch_batches``, the in-memory counterpart of the HDF5 test
dataset and loader that feeds a predictor.  numpy only."""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .slice_builder import get_slice_builder


def calculate_stats(img: Optional[np.ndarray],
                    skip: bool = False) -> Dict[str, Any]:
    """1%/99.6% percentiles + mean/std over the whole raw volume."""
    if not skip:
        pmin, pmax, mean, std = (
            np.percentile(img, 1),
            np.percentile(img, 99.6),
            np.mean(img),
            np.std(img),
        )
    else:
        pmin = pmax = mean = std = None
    return {"pmin": pmin, "pmax": pmax, "mean": mean, "std": std}


def mirror_pad(image: np.ndarray, padding_shape: Sequence[int]) -> np.ndarray:
    """Reflect-pad each spatial dim by its halo (ZYX; a leading channel dim
    untouched)."""
    if len(padding_shape) != 3:
        raise ValueError("halo needs one entry per spatial axis (Z, Y, X)")
    if any(p < 0 for p in padding_shape):
        raise ValueError(f"negative halo entries: {tuple(padding_shape)}")
    if all(p == 0 for p in padding_shape):
        return image
    pad_width = [(p, p) for p in padding_shape]
    if image.ndim == 4:
        pad_width = [(0, 0)] + pad_width
    return np.pad(image, pad_width, mode="reflect")


def remove_padding(m: np.ndarray,
                   padding_shape: Optional[Sequence[int]]) -> np.ndarray:
    """Strip the halo margins added by mirror_pad (leading dims untouched)."""
    if padding_shape is None:
        return m
    return m[(..., *(slice(p, -p or None) for p in padding_shape))]


def create_padded_indexes(indexes: Sequence[slice],
                          halo_shape: Sequence[int]) -> Tuple[slice, ...]:
    """Patch slices into the mirror-padded volume: same start, stop +
    2*halo."""
    return tuple(
        slice(index.start, index.stop + 2 * halo)
        for index, halo in zip(indexes, halo_shape)
    )


def traverse_h5_paths(file_paths: Sequence[str]) -> List[str]:
    """Expand directories to the *.h5 / *.hdf / *.hdf5 / *.hd5 files inside
    them (in glob order, extension by extension); files pass through."""
    if not isinstance(file_paths, list):
        raise TypeError(f"file_paths must be a list, got "
                        f"{type(file_paths).__name__}")
    results = []
    for file_path in file_paths:
        if os.path.isdir(file_path):
            for ext in ("*.h5", "*.hdf", "*.hdf5", "*.hd5"):
                results.extend(glob.glob(os.path.join(file_path, ext)))
        else:
            results.append(file_path)
    return results


def padded_patch_batches(raw: np.ndarray, slice_builder: Dict[str, Any],
                         batch_size: int,
                         ) -> Iterator[Tuple[np.ndarray, List[Tuple[slice, ...]]]]:
    """Batches ``(patches (B, pd+2hz, ph+2hy, pw+2hx, 1) float32, [index
    tuples])`` of a (D, H, W) volume for a config's ``slice_builder``
    section (name, patch_shape, stride_shape, halo_shape): each window is
    cut from the mirror-padded volume with its halo and given a trailing
    channel, as the HDF5 test dataset with ``ToTensor(expand_dims)`` and the
    loader yield them.  The last batch may be short."""
    halo = slice_builder.get("halo_shape", (0, 0, 0))
    padded = mirror_pad(raw, halo)
    slices = get_slice_builder(raw, None, None, slice_builder).raw_slices
    for b0 in range(0, len(slices), batch_size):
        idx = slices[b0:b0 + batch_size]
        batch = np.stack([
            padded[create_padded_indexes(s, halo)] for s in idx
        ]).astype(np.float32)[..., None]
        yield batch, idx
