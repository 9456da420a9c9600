"""On-device 2D train-time augmentation (the JAX package's
``transforms/device2d.py``), for square images:

    HorizontalFlip(p=.5) · VerticalFlip(p=.5) · RandomRotate90(p=.5)
    · Transpose(p=.5) · RandomBrightnessContrast(p=.5)

in that order.  The whole batch is augmented at once on its device.
Geometry applies to image and mask together; brightness/contrast to the
image only, clipped to [0, 1].  RandomRotate90, when it triggers, turns by
k ∈ {0, 1, 2, 3} quarter-turns drawn uniformly.

Each transform is split into a draw (``draw_augment``: the per-sample
decisions, from an explicit ``torch.Generator`` on the batch's device) and
an application given the draws (``apply_augment``), so the same decisions
can be fed to the JAX package's transforms.  PyTorch's generator and JAX's
keys give different streams: parity is by decision, and by distribution
for the draws.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Augment2DConfig:
    p_hflip: float = 0.5
    p_vflip: float = 0.5
    p_rot90: float = 0.5
    p_transpose: float = 0.5
    p_brightness_contrast: float = 0.5
    brightness_limit: float = 0.2
    contrast_limit: float = 0.2


@dataclasses.dataclass
class AugmentDraws:
    """Per-sample decisions, each of shape (N,): flags (bool), the
    quarter-turn count (int64, 0 when RandomRotate90 does not trigger) and
    the contrast and brightness factors (float32)."""

    hflip: torch.Tensor
    vflip: torch.Tensor
    k90: torch.Tensor
    transpose: torch.Tensor
    brightness_contrast: torch.Tensor
    alpha: torch.Tensor  # contrast: 1 + U(-contrast_limit, contrast_limit)
    beta: torch.Tensor   # brightness: U(-brightness_limit, brightness_limit)


def draw_augment(n: int, cfg: Augment2DConfig,
                 generator: torch.Generator) -> AugmentDraws:
    """The decisions for a batch of ``n``, on the generator's device."""
    dev = generator.device
    u = torch.rand((7, n), generator=generator, device=dev)
    k = torch.randint(0, 4, (n,), generator=generator, device=dev)
    c, b = cfg.contrast_limit, cfg.brightness_limit
    return AugmentDraws(
        hflip=u[0] < cfg.p_hflip,
        vflip=u[1] < cfg.p_vflip,
        k90=torch.where(u[2] < cfg.p_rot90, k, torch.zeros_like(k)),
        transpose=u[3] < cfg.p_transpose,
        brightness_contrast=u[4] < cfg.p_brightness_contrast,
        alpha=1.0 + (-c + (2 * c) * u[5]),
        beta=-b + (2 * b) * u[6],
    )


def _where(do: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    return torch.where(do.view(-1, *([1] * (old.ndim - 1))), new, old)


def apply_augment(images: torch.Tensor, labels: torch.Tensor,
                  draws: AugmentDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the draws to images (N, H, W, C) in [0, 1] and labels
    (N, H, W[, Cm]); H must equal W."""
    if images.shape[1] != images.shape[2]:
        raise ValueError(f"augment takes square images (rot90, transpose), "
                         f"got {tuple(images.shape)}")
    out = []
    for a in (images, labels):
        a = _where(draws.hflip, a.flip(2), a)  # left-right
        a = _where(draws.vflip, a.flip(1), a)  # up-down
        turned = a
        for k in (1, 2, 3):
            turned = _where(draws.k90 == k, torch.rot90(a, k, dims=(1, 2)),
                            turned)
        a = _where(draws.transpose, turned.transpose(1, 2), turned)
        out.append(a)
    images, labels = out
    shape = (-1, *([1] * (images.ndim - 1)))
    bc = (images * draws.alpha.view(shape).to(images.dtype)
          + draws.beta.view(shape).to(images.dtype)).clamp(0.0, 1.0)
    return _where(draws.brightness_contrast, bc, images), labels


def augment_batch(images: torch.Tensor, labels: torch.Tensor,
                  cfg: Augment2DConfig = Augment2DConfig(),
                  generator: torch.Generator = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw and apply the reference train augmentations to a whole batch;
    ``generator`` lives on the batch's device."""
    if generator is None or generator.device.type != images.device.type:
        raise ValueError("augment_batch needs a torch.Generator on the "
                         f"batch's device ({images.device})")
    return apply_augment(images, labels,
                         draw_augment(images.shape[0], cfg, generator))
