"""Transforms of the port (the JAX package's ``transforms``; the on-device
2D train-time augmentation so far)."""

from .device2d import (
    Augment2DConfig,
    AugmentDraws,
    apply_augment,
    augment_batch,
    draw_augment,
)

__all__ = ["Augment2DConfig", "AugmentDraws", "apply_augment",
           "augment_batch", "draw_augment"]
