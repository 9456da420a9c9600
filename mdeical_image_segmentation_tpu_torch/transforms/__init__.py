"""Transforms of the port (the JAX package's ``transforms``): the on-device
2D train-time augmentation here; the host-side volume transforms in
``transforms.volume`` (with ``transforms.skimage_compat``)."""

from .device2d import (
    Augment2DConfig,
    AugmentDraws,
    apply_augment,
    augment_batch,
    draw_augment,
)

__all__ = ["Augment2DConfig", "AugmentDraws", "apply_augment",
           "augment_batch", "draw_augment"]
