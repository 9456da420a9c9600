"""Patch indexing over volumes (the JAX package's
``data/slice_builder.py``: ``SliceBuilder`` and ``FilterSliceBuilder``,
found by name through ``get_slice_builder``).

A volume of shape DxHxW (or CxDxHxW) is tiled into fixed-shape patches at
stride intervals, z-major; the walk always covers the tail of every axis
(a last patch flush with the end is added when the strided walk stops
short).  ``FilterSliceBuilder`` drops mostly-background patches, with the
JAX package's RandomState(47) rescue stream.  numpy only.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Tuple

import numpy as np

from ..configs.registry import Registry

SLICE_BUILDERS = Registry("slice_builder")


def _axis_starts(extent: int, patch: int, stride: int) -> List[int]:
    """Start offsets of patches along one axis: a strided walk plus, when
    the walk does not reach it, one start flush with the axis end."""
    if extent < patch:
        raise ValueError(
            f"volume axis ({extent}) shorter than the patch axis ({patch})")
    starts = list(range(0, extent - patch + 1, stride))
    if starts[-1] + patch < extent:
        starts.append(extent - patch)
    return starts


@SLICE_BUILDERS.register("SliceBuilder")
class SliceBuilder:
    """Enumerates (z, y, x[, c]) slice tuples for raw/label/weight arrays."""

    def __init__(self, raw_dataset, label_dataset, weight_dataset,
                 patch_shape, stride_shape, **kwargs):
        patch_shape = tuple(patch_shape)
        stride_shape = tuple(stride_shape)
        if not kwargs.get("skip_shape_check", False):
            self._check_patch_shape(patch_shape)
        self._raw_slices = self._build_slices(raw_dataset, patch_shape,
                                              stride_shape)
        self._label_slices = None
        self._weight_slices = None
        if label_dataset is not None:
            self._label_slices = self._build_slices(
                label_dataset, patch_shape, stride_shape)
            assert len(self._raw_slices) == len(self._label_slices)
        if weight_dataset is not None:
            self._weight_slices = self._build_slices(
                weight_dataset, patch_shape, stride_shape)
            assert len(self._raw_slices) == len(self._weight_slices)

    @property
    def raw_slices(self):
        return self._raw_slices

    @property
    def label_slices(self):
        return self._label_slices

    @property
    def weight_slices(self):
        return self._weight_slices

    @staticmethod
    def _build_slices(dataset, patch_shape,
                      stride_shape) -> List[Tuple[slice, ...]]:
        """All patch windows, z-major (z → y → x), channels whole."""
        spatial = dataset.shape[-3:]
        channels = dataset.shape[0] if dataset.ndim == 4 else None
        per_axis = [
            _axis_starts(extent, patch, stride)
            for extent, patch, stride in zip(spatial, patch_shape,
                                             stride_shape)
        ]
        windows = []
        for origin in itertools.product(*per_axis):
            window = tuple(slice(start, start + patch)
                           for start, patch in zip(origin, patch_shape))
            if channels is not None:
                window = (slice(0, channels),) + window
            windows.append(window)
        return windows

    @staticmethod
    def _check_patch_shape(patch_shape):
        if len(patch_shape) != 3:
            raise ValueError(f"patch_shape needs 3 axes, got {patch_shape}")
        if patch_shape[1] < 64 or patch_shape[2] < 64:
            raise ValueError("patch H and W must be at least 64")


@SLICE_BUILDERS.register("FilterSliceBuilder")
class FilterSliceBuilder(SliceBuilder):
    """Keeps the patches whose non-ignore label fraction exceeds
    ``threshold``, plus a ``slack_acceptance`` rescue of the others: a
    ``RandomState(47)`` draw made only for a patch that fails the fraction
    test.  The weight slices are filtered with the raw and label ones."""

    def __init__(self, raw_dataset, label_dataset, weight_dataset,
                 patch_shape, stride_shape, ignore_index=None, threshold=0.6,
                 slack_acceptance=0.01, **kwargs):
        super().__init__(raw_dataset, label_dataset, weight_dataset,
                         patch_shape, stride_shape, **kwargs)
        if label_dataset is None:
            return
        rescue_rng = np.random.RandomState(47)

        def keep(label_window) -> bool:
            patch = label_dataset[label_window]
            if ignore_index is not None:
                patch = np.copy(patch)
                patch[patch == ignore_index] = 0
            foreground = np.count_nonzero(patch != 0) / patch.size
            return (foreground > threshold
                    or rescue_rng.rand() < slack_acceptance)

        keep_mask = [keep(w) for w in self._label_slices]
        self._raw_slices = [s for s, k in zip(self._raw_slices, keep_mask)
                            if k]
        self._label_slices = [s for s, k in zip(self._label_slices,
                                                keep_mask) if k]
        if self._weight_slices is not None:
            self._weight_slices = [s for s, k in zip(self._weight_slices,
                                                     keep_mask) if k]


def get_slice_builder(raws, labels, weight_maps, config: Dict[str, Any]):
    """Name-dispatched construction from a ``slice_builder`` config."""
    cls = SLICE_BUILDERS.get(config["name"])
    return cls(raws, labels, weight_maps,
               **{k: v for k, v in config.items() if k != "name"})
