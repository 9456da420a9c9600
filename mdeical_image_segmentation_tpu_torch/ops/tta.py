"""Mirror test-time augmentation: flip-ensemble forward passes (the JAX
package's ``ops/tta.py``)."""

from __future__ import annotations

from itertools import combinations
from typing import Callable, List, Sequence

import torch


def mirror_combos(axes: Sequence[int]) -> List[List[int]]:
    """All 2^k subsets of ``axes`` (as lists, [] = identity pass first)."""
    return [list(c) for r in range(len(axes) + 1)
            for c in combinations(axes, r)]


def flip_ensemble(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                  combos: Sequence[Sequence[int]],
                  x: torch.Tensor) -> torch.Tensor:
    """Mean of ``apply_fn(flip(x, c))`` flipped back into place, over every
    axis combination ``c`` in ``combos`` (averaged in the space ``apply_fn``
    returns: logits at the serving call site).  Under the int8 PTQ 'calib'
    mode (``ops/quant.py``) every pass folds its activations into the same
    scales dict, so calibration observes every flip variant."""
    acc = None
    for c in combos:
        o = apply_fn(torch.flip(x, list(c)) if c else x)
        o = torch.flip(o, list(c)) if c else o
        acc = o if acc is None else acc + o
    return acc / len(combos)
