"""Host-side data helpers of the port: the 2D PNG datasets, collation and
batch loading, and the 3D volume helpers."""

from .collate import BatchLoader, BUSIDataCollator, DRIVEDataCollator, SliceCollator
from .png2d import (
    BUSIDataset,
    DRIVEDataset,
    SliceDataset,
    SyntheticSliceDataset,
    nearest_resize,
)

__all__ = ["BUSIDataCollator", "BUSIDataset", "BatchLoader",
           "DRIVEDataCollator", "DRIVEDataset", "SliceCollator",
           "SliceDataset", "SyntheticSliceDataset", "nearest_resize"]
