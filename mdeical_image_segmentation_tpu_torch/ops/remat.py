"""Rematerialization of the 2D and 3D models' blocks (the JAX package's
``ops/remat.py``).

The JAX package wraps each block (``UNetConv2``, ``ConvBNReLU``, the
classic UNet's ``DoubleConvolution``) in ``nn.remat`` with a name-based
checkpoint policy.  The port reads the policies structurally, one
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` per block
or per stage of a block, which recomputes the same operations on the same
inputs and so gives the same values:

- ``None`` — the whole block is recomputed in the backward (only its input
  is kept);
- ``"save_convs"`` — each conv's output is kept and only the BatchNorm +
  ReLU tail after it is recomputed;
- ``"save_convs_norms"`` — the BatchNorm output is kept too, only the ReLU
  is recomputed;
- ``"everything"`` — nothing is recomputed (remat without effect).

In a block of two convs (``UNetConv2``) the second conv keeps its input for
its weight gradient, where XLA would recompute that input from the first
conv's output: the one place the port keeps more than the JAX policy.
``DoubleConvolution`` runs as one autograd Function that keeps its conv
outputs already, so only ``None`` changes it (kernel 1 runs again in the
backward).

BatchNorm's running statistics are updated once per forward, outside the
recomputed functions: a non-reentrant checkpoint re-runs the Python
forward in the backward, and an update inside it would run twice (JAX's
remat is functional and updates them once).  Unknown policy names raise.

The 3D family (``models/unet3d.py``) wraps each ``Encoder`` and
``Decoder`` as the JAX package wraps them in ``nn.remat``
(``checkpoint_block``).  Its blocks are built of autograd Functions that
keep their own residuals: the fused 'gcr' SingleConv
(``fused_conv.gcr_fused_conv``) keeps its input, its output (the conv's,
after the ReLU) and the (N, C) GroupNorm statistics, and never stores the
normalized tensor; the ``GroupNorm`` Function keeps its input and the
statistics.  So:

- ``None`` — the whole Encoder / Decoder runs under one non-reentrant
  checkpoint and again in the backward (kernel 2 and the GroupNorm
  statistics kernel launch twice a step for each fused SingleConv);
- ``"save_convs"``, ``"save_convs_norms"``, ``"everything"`` — the blocks
  run as they are: what their Functions keep is the conv outputs and the
  statistics, which is what those policies keep.  The unfused orders keep
  a little more than the JAX policies (the norm's output before the conv
  under ``save_convs``, each ReLU's output).

A recompute must draw the same dropout masks and must not update the
BatchNorm running statistics a second time: ``checkpoint_block`` hands the
block's modules a ``Replay`` record, in which the first run stores its
masks (the recompute reads them back in call order) and which tells the
recompute to leave the running statistics alone.  The masks are kept as
booleans, one byte an element, where JAX re-derives them from its key.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

POLICIES = (None, "save_convs", "save_convs_norms", "everything")


def resolve_policy(name: Optional[str]) -> Optional[str]:
    """The policy ``name`` stands for (``"none"`` is ``None``); unknown names
    raise."""
    if name == "none":
        return None
    if name not in POLICIES:
        raise ValueError(
            f"remat_policy={name!r}: expected None/'none', 'save_convs', "
            "'save_convs_norms', or 'everything'")
    return name


def _recompute(fn: Callable, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


Stage = Tuple[Callable, Optional[torch.nn.Module]]  # (conv, batch norm)


def run_stages(stages: Sequence[Stage], x: torch.Tensor, *, remat: bool,
               policy: Optional[str]) -> torch.Tensor:
    """``relu(bn(conv(x)))`` for each (conv, bn) of ``stages`` in turn (bn
    may be None), rematerialized by ``policy`` when ``remat`` is on and
    autograd records; then each bn's running statistics are updated from
    the batch statistics of this forward."""
    recording = remat and torch.is_grad_enabled()
    stats: List = []

    def tail(c, bn):
        if bn is None:
            return F.relu(c), None
        y, st = bn.normalize(c)
        return F.relu(y), st

    if not recording or policy == "everything":
        for conv, bn in stages:
            x, st = tail(conv(x), bn)
            stats.append(st)
    elif policy is None:
        def body(x):
            out = []
            for conv, bn in stages:
                x, st = tail(conv(x), bn)
                out.append(st)
            return x, out
        x, stats = _recompute(body, x)
    elif policy == "save_convs":
        for conv, bn in stages:
            x, st = _recompute(tail, conv(x), bn)
            stats.append(st)
    else:  # save_convs_norms
        for conv, bn in stages:
            c = conv(x)
            y, st = (c, None) if bn is None else bn.normalize(c)
            x = _recompute(F.relu, y)
            stats.append(st)
    for (_, bn), st in zip(stages, stats):
        if bn is not None:
            bn.update(st)
    return x


def run_block(fn: Callable, x: torch.Tensor, *, remat: bool,
              policy: Optional[str]) -> torch.Tensor:
    """A block that keeps its own conv outputs (``DoubleConvolution``):
    recomputed whole under the ``None`` policy, run as it is otherwise."""
    if remat and policy is None and torch.is_grad_enabled():
        return _recompute(fn, x)
    return fn(x)


class Replay:
    """What the first run of a rematerialized block drew, for its
    recompute: the dropout keep-masks in call order.  ``recompute`` is set
    once the first run is over."""

    def __init__(self):
        self.masks: List[torch.Tensor] = []
        self.recompute = False
        self.pos = 0

    def keep_mask(self, draw: Callable[[], torch.Tensor]) -> torch.Tensor:
        """``draw()`` on the first run, its result again in the recompute."""
        if self.recompute:
            mask = self.masks[self.pos]
            self.pos += 1
            return mask
        mask = draw()
        self.masks.append(mask)
        return mask


def checkpoint_block(block: torch.nn.Module, *args: torch.Tensor):
    """``block(*args)`` under a non-reentrant checkpoint: only the inputs
    are kept and the block runs again in the backward.  Every submodule
    with a ``replay`` attribute (dropout, BatchNorm holders) gets the same
    ``Replay`` for both runs."""
    replay = Replay()
    holders = [m for m in block.modules() if hasattr(m, "replay")]

    def body(*inputs):
        replay.pos = 0
        for m in holders:
            m.replay = replay
        try:
            return block(*inputs)
        finally:
            for m in holders:
                m.replay = None
            replay.recompute = True

    return _recompute(body, *args)
