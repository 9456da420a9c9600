"""Segmentation serving on the port (the JAX package's ``serve``)."""

from .app import (
    BatchingInferenceEngine,
    ModelEntry,
    ModelRegistry,
    SegmentationServer,
    serve,
)

__all__ = [
    "BatchingInferenceEngine",
    "ModelEntry",
    "ModelRegistry",
    "SegmentationServer",
    "serve",
]
