"""Spatially sharded 3D forward and training with halo exchange (the JAX
package's ``parallel/spatial.py``).

One volume's ``shard_axis`` (H of an (N, D, H, W, C) volume by default) is
split into equal slabs, one a rank of a ``torch.distributed`` group (one
process per card).  Each rank exchanges ``halo`` rows with its neighbours
(``_HaloExchange``: the first and last ranks reflect-pad at the volume's
edges, as ``mirror_pad`` does), runs the model on its haloed slab and crops
the halo off the output.  With ``halo`` at least the model's half receptive
field the interior equals the monolithic forward for normalization-free
orders; GroupNorm statistics are per slab by default (the patch semantics
the reference's patch training has), or, with ``cross_shard_norm``, summed
over the ranks from each slab's interior rows
(``ops/norm.py::cross_shard_group_stats``), which makes the result the same
for any number of ranks.

The training step minimizes the mean of the per-slab criteria: for
per-voxel means (BCE, MSE) that is the whole volume's loss, for ratio
losses (Dice) the per-slab one.  The gradients are averaged over the ranks
with one flat all-reduce after the backward (the JAX ``lax.pmean``), not
by DDP: the backward issues halo exchanges and GroupNorm all-reduces on
the same group, and every rank must issue the collectives in one order.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from ..ops.norm import cross_shard_group_stats


def group_size(group: Any = None) -> int:
    """Ranks in ``group`` (None: the default group; 1 without one)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group: Any = None) -> int:
    """This process's rank in ``group`` (0 without a process group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def _take(x: torch.Tensor, axis: int, start: int, stop: int
          ) -> torch.Tensor:
    return x.narrow(axis, start, stop - start)


def _neighbours(group: Any):
    """(left, right) ranks of this one in ``group``, None at an edge."""
    world, rank = group_size(group), group_rank(group)
    return (rank - 1 if rank > 0 else None,
            rank + 1 if rank < world - 1 else None)


def _swap(sends: List[torch.Tensor], peers: List[Optional[int]],
          group: Any) -> List[Optional[torch.Tensor]]:
    """Send ``sends[k]`` to rank ``peers[k]`` of ``group`` and receive a
    tensor of its shape from it, point to point (a None peer: nothing
    either way, None back).  gloo does not take CUDA tensors point to
    point, so under gloo a CUDA halo goes through the host; gloo serves
    only to share one card between ranks, and NCCL is the path between
    cards."""
    if all(p is None for p in peers):
        return [None] * len(peers)
    staged = dist.get_backend(group) == "gloo"
    ops, recvs = [], []
    for send, peer in zip(sends, peers):
        if peer is None:
            recvs.append(None)
            continue
        src = send.contiguous()
        buf = torch.empty_like(src)
        if staged:
            src, buf = src.cpu(), buf.cpu()
        if group is not None:
            peer = dist.get_global_rank(group, peer)
        ops += [dist.P2POp(dist.isend, src, peer, group),
                dist.P2POp(dist.irecv, buf, peer, group)]
        recvs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [None if r is None else r.to(s.device)
            for r, s in zip(recvs, sends)]


class _HaloExchange(torch.autograd.Function):
    """``[from_left, x, from_right]`` along ``axis``: rank i sends its last
    ``halo`` rows right and its first ``halo`` rows left; the first rank
    takes the flip of its rows 1..halo in place of a left neighbour's, the
    last the flip of its rows -halo-1..-2.  The backward is the inverse
    permutation: a received strip's cotangent goes back to the rank that
    sent it and is added to its edge rows; a reflect-pad's is flipped and
    added to the rows it mirrors."""

    @staticmethod
    def forward(ctx, x, halo, axis, group):
        ctx.halo, ctx.axis, ctx.group = halo, axis, group
        e = x.shape[axis]
        from_left, from_right = _swap(
            [_take(x, axis, 0, halo), _take(x, axis, e - halo, e)],
            list(_neighbours(group)), group)
        if from_left is None:
            from_left = _take(x, axis, 1, halo + 1).flip(axis)
        if from_right is None:
            from_right = _take(x, axis, e - halo - 1, e - 1).flip(axis)
        return torch.cat([from_left, x, from_right], dim=axis)

    @staticmethod
    def backward(ctx, gy):
        halo, axis, group = ctx.halo, ctx.axis, ctx.group
        ep = gy.shape[axis]
        e = ep - 2 * halo
        g_left = _take(gy, axis, 0, halo)
        g_right = _take(gy, axis, ep - halo, ep)
        dx = _take(gy, axis, halo, ep - halo).clone()
        left, right = _neighbours(group)
        # a strip's cotangent goes back to its sender: the left strip came
        # from the left neighbour's last rows, the right strip from the
        # right neighbour's first rows
        from_left, from_right = _swap([g_left, g_right], [left, right],
                                      group)
        if left is None:
            _take(dx, axis, 1, halo + 1).add_(g_left.flip(axis))
        else:
            _take(dx, axis, 0, halo).add_(from_left)
        if right is None:
            _take(dx, axis, e - halo - 1, e - 1).add_(g_right.flip(axis))
        else:
            _take(dx, axis, e - halo, e).add_(from_right)
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, halo: int, axis: int,
                  group: Any = None) -> torch.Tensor:
    """x with ``halo`` rows from each neighbour's slab concatenated on both
    sides of ``axis`` (reflect-padded at the volume's edges);
    differentiable."""
    return _HaloExchange.apply(x, halo, axis, group)


def _check_slab(extent: int, halo: int) -> None:
    # strict: the edge's reflection mirrors rows 1..halo, needing extent >
    # halo
    if not 0 < halo < extent:
        raise ValueError(f"halo {halo} must be in (0, shard extent "
                         f"{extent})")


def shard_slab(volume: torch.Tensor, group: Any = None,
               shard_axis: int = 2) -> torch.Tensor:
    """This rank's slab of ``volume`` along ``shard_axis``: rows
    ``[rank·e, (rank+1)·e)`` with e the extent over the ranks (a view)."""
    n = group_size(group)
    extent = volume.shape[shard_axis]
    if extent % n:
        raise ValueError(f"spatial axis extent {extent} not divisible by "
                         f"{n} shards")
    e = extent // n
    return volume.narrow(shard_axis, group_rank(group) * e, e)


def _norm_mode(cross_shard_norm: bool, group: Any, shard_axis: int,
               halo: int, padded_extent: int):
    if cross_shard_norm:
        return cross_shard_group_stats(group, shard_axis, halo,
                                       padded_extent)
    return contextlib.nullcontext()


def _crop(out: torch.Tensor, halo: int, axis: int) -> torch.Tensor:
    return _take(out, axis, halo, out.shape[axis] - halo)


def spatial_sharded_apply(model: torch.nn.Module, volume_slab: torch.Tensor,
                          group: Any = None, *, halo: int,
                          shard_axis: int = 2,
                          cross_shard_norm: bool = False) -> torch.Tensor:
    """The forward of this rank's slab of one volume (``shard_slab``):
    halo exchange, the model as it is (its train or eval mode), the halo
    cropped off: this rank's slab of the output.  ``cross_shard_norm``
    sums GroupNorm statistics over the ranks (needs ``halo`` divisible by
    ``2**(num_levels - 1)``).  Every rank of ``group`` calls it."""
    _check_slab(volume_slab.shape[shard_axis], halo)
    xh = halo_exchange(volume_slab, halo, shard_axis, group)
    with _norm_mode(cross_shard_norm, group, shard_axis, halo,
                    xh.shape[shard_axis]):
        out = model(xh)
    return _crop(out, halo, shard_axis)


def _average_gradients(params: List[torch.nn.Parameter], group: Any = None
                       ) -> None:
    """Every parameter's gradient averaged over the ranks, in one flat
    all-reduce (the JAX ``lax.pmean(grads)``)."""
    world = group_size(group)
    grads = [p.grad for p in params if p.grad is not None]
    if world == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_spatial_train_step(
    model: torch.nn.Module,
    criterion: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    optimizer: torch.optim.Optimizer, group: Any = None, *, halo: int,
    shard_axis: int = 2, cross_shard_norm: bool = False, seed: int = 0,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """A step over one spatially sharded volume: ``step(x_slab, y_slab)``
    (this rank's slabs) halo-exchanges the slab, runs the forward, crops the
    halo, computes the per-slab criterion, runs the backward, averages the
    gradients over the ranks and takes the optimizer step; it returns the
    ranks' mean loss (detached).  The model runs in its own mode
    (``model.train()`` for dropout); its dropout draws from a generator
    seeded from ``seed`` with the rank folded in, as the JAX step folds the
    axis index into its key.  Every rank of ``group`` calls it for the same
    volumes."""
    # models import parallel (BatchNorm's global statistics): import late
    from ..models.blocks3d import set_dropout_generator

    world, rank = group_size(group), group_rank(group)
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device if params else torch.device("cpu")
    set_dropout_generator(model, torch.Generator(device=device)
                          .manual_seed(seed + 1 + 1_000_003 * rank))

    def step(x_slab: torch.Tensor, y_slab: torch.Tensor) -> torch.Tensor:
        _check_slab(x_slab.shape[shard_axis], halo)
        optimizer.zero_grad(set_to_none=True)
        xh = halo_exchange(x_slab, halo, shard_axis, group)
        # the backward runs inside the mode too: a rematerialized block
        # runs its forward again there
        with _norm_mode(cross_shard_norm, group, shard_axis, halo,
                        xh.shape[shard_axis]):
            out = _crop(model(xh), halo, shard_axis)
            loss = criterion(out, y_slab)
            loss.backward()
        _average_gradients(params, group)
        optimizer.step()
        loss = loss.detach().clone()
        if world > 1:
            dist.all_reduce(loss, group=group)
            loss.div_(world)
        return loss

    return step
