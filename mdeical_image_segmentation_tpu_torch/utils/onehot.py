"""One-hot expansion with ``ignore_index`` kept (the JAX package's
``utils/onehot.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def expand_as_one_hot(labels: torch.Tensor, num_classes: int,
                      ignore_index: Optional[int] = None) -> torch.Tensor:
    """(N, *spatial) integer labels → (N, *spatial, C) float32 one-hot
    (channels-last); ``ignore_index`` voxels hold ``ignore_index`` in every
    channel, so later masking finds them."""
    t = labels.long()
    if ignore_index is None:
        return F.one_hot(t, num_classes).float()
    mask = t == ignore_index
    onehot = F.one_hot(torch.where(mask, 0, t), num_classes).float()
    return torch.where(mask[..., None], float(ignore_index), onehot)
