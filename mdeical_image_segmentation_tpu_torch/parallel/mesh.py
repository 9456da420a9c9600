"""The data axis of a data-parallel run (the JAX package's
``parallel/mesh.py``, its ``data`` axis).

The JAX package trains one GSPMD program over a device mesh, "as if on one
big device": the global batch is sharded over the ``data`` axis, so every
batch statistic (BatchNorm's, a Dice ratio's, an eval sum) is the global
batch's.  The port runs one process per device under DDP.  A ``DataMesh``
is the process group's data axis, this process's rank on it and its
device; ``shard_batch`` gives a rank the rows the JAX mesh puts on its
device, ``[rank·local : (rank+1)·local]`` of the global batch, or the
whole batch when its rows do not divide (JAX replicates such a tail).

Global statistics: while a batch's rows are split over the ranks (inside
``rows_split(mesh)``), ``global_sum`` adds a per-rank partial sum over
the ranks, differentiably, and BatchNorm reduces its statistics the same
way (``ops/batchnorm.py``).  Outside it, and on a replicated tail that
every rank holds whole, they are local: all-reducing a replicated batch
would count it ``world`` times.  The split is process-wide state, not a
context variable, because a rematerialized block runs again inside the
backward, on the autograd engine's thread.  Spatial sharding splits one
volume over the same ranks (``parallel/spatial.py``); the model axis
(channel tensor parallelism, ZeRO-1) waits for ROADMAP.md queue 1, items
25b.2 and 25b.3.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
MODEL_AXIS_ITEM = ("ROADMAP.md queue 1, item 25b (25b.2 tensor-parallel and "
                   "25b.3 ZeRO-1 modes)")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``size`` processes on the data axis, this one ``rank`` on ``device``;
    ``group`` None is the default process group (or none, for a size of
    1 without one)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.size, MODEL_AXIS: 1}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *,
              device: Union[str, torch.device] = "cuda") -> DataMesh:
    """The data axis over every process of the group (one process when
    there is none), on this process's ``device``: the current card by
    default, ``"cpu"`` when asked."""
    if n_model > 1:
        raise NotImplementedError(
            f"make_mesh(n_model={n_model}): the model axis is not ported "
            f"yet ({MODEL_AXIS_ITEM})")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is not None and n_data != world:
        raise ValueError(f"make_mesh(n_data={n_data}): the port runs one "
                         f"process per device and this group has {world}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda') needs a CUDA card; "
                               "pass device='cpu' on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    return DataMesh(world, rank, device)


def _rows(v) -> Optional[int]:
    return None if v is None or np.ndim(v) == 0 else int(np.shape(v)[0])


def _values(batch):
    return batch.values() if isinstance(batch, dict) else batch


def _map(batch, fn):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return type(batch)(fn(v) for v in batch)


def divides(mesh: DataMesh, batch) -> bool:
    """Whether every array of ``batch`` (a dict or a tuple; None entries
    and scalars aside) has rows that split evenly over the data axis."""
    return all(n % mesh.size == 0 for n in map(_rows, _values(batch))
               if n is not None)


def shard_batch(mesh: DataMesh, batch):
    """This rank's rows ``[rank·local : (rank+1)·local]`` of a global
    batch (numpy arrays or tensors in a dict or a tuple), or the whole
    batch when its rows do not divide over the data axis: such a tail is
    replicated, every rank computes it whole, and its statistics are
    local (no ``rows_split``)."""
    if mesh.size == 1 or not divides(mesh, batch):
        return batch

    def rows(v):
        n = _rows(v)
        if n is None:
            return v
        local = n // mesh.size
        return v[mesh.rank * local:(mesh.rank + 1) * local]

    return _map(batch, rows)


def replicate(mesh: DataMesh, tree):
    """``tree`` (tensors and numpy arrays in dicts, lists and tuples; other
    leaves are sent as objects) as rank 0 holds it, on every rank.  Tensors
    are overwritten in place."""
    if mesh.size == 1:
        return tree
    objects = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            dist.broadcast(t, src=0, group=mesh.group)
            return t
        if isinstance(t, np.ndarray):
            buf = torch.from_numpy(np.ascontiguousarray(t)).to(mesh.device)
            dist.broadcast(buf, src=0, group=mesh.group)
            return buf.cpu().numpy()
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        objects.append(t)
        return _Leaf(len(objects) - 1)

    walked = walk(tree)
    if not objects:
        return walked
    dist.broadcast_object_list(objects, src=0, group=mesh.group)

    def fill(t):
        if isinstance(t, _Leaf):
            return objects[t.index]
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v) for v in t)
        return t

    return fill(walked)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    index: int


def local_batch_size(mesh: DataMesh, per_device: int) -> int:
    """The global batch of a per-device batch (the reference CLI's
    ``per_device_*_batch_size``)."""
    return per_device * mesh.size


def device_prefetch(iterator, mesh: DataMesh, size: int = 2,
                    put=None) -> Iterator[Any]:
    """``iterator``'s batches placed ``size`` batches ahead: by default
    this rank's rows (``shard_batch``) copied to the mesh's device, or by
    ``put``."""
    def default_put(batch):
        return _map(shard_batch(mesh, batch), lambda v: v if v is None else
                    torch.as_tensor(np.asarray(v) if not isinstance(
                        v, torch.Tensor) else v, device=mesh.device))

    _put = put if put is not None else default_put
    queue = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(_put(batch))
        if len(queue) >= size:
            break
    while queue:
        for batch in it:
            queue.append(_put(batch))
            break
        yield queue.popleft()


def wrap_ddp(model: torch.nn.Module, device: torch.device,
             find_unused_parameters: bool = False) -> torch.nn.Module:
    """``model`` under DDP when a process group is up, else ``model``: its
    parameters broadcast from rank 0 and its gradients averaged over the
    ranks.  The buffers are not broadcast: BatchNorm's running statistics
    are updated from the global batch's statistics, the same on every
    rank."""
    if not dist.is_initialized():
        return model
    ids = ([device.index if device.index is not None
            else torch.cuda.current_device()] if device.type == "cuda"
           else None)
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=ids, broadcast_buffers=False,
        find_unused_parameters=find_unused_parameters)


# -- global statistics over the ranks that split a batch's rows -------------

_SPLIT: Optional[DataMesh] = None


@contextlib.contextmanager
def rows_split(mesh: Optional[DataMesh]):
    """Within: the current batch's rows are split over ``mesh``'s ranks
    (nothing for a size of 1 or None).  Wrap a step's forward and backward
    in it; every rank enters it for the same batches."""
    global _SPLIT
    prev = _SPLIT
    _SPLIT = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _SPLIT = prev


def split_mesh() -> Optional[DataMesh]:
    """The mesh whose ranks split the current batch's rows, or None."""
    return _SPLIT


def all_sum(x: torch.Tensor, mesh: Optional[DataMesh] = None
            ) -> torch.Tensor:
    """``x`` summed over ``mesh``'s ranks (the split mesh by default; x
    itself without one), without gradient."""
    mesh = mesh if mesh is not None else _SPLIT
    if mesh is None or mesh.size == 1:
        return x
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=mesh.group)
    return y


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the sum, so each rank's partial sum gets
        # the gradient summed over the ranks; DDP's average then divides
        # by the world size, which leaves the single-device gradient
        return all_sum(g, ctx.mesh), None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A per-rank partial sum ``x`` summed over the ranks that split the
    batch's rows (``x`` itself outside ``rows_split``), differentiably."""
    if _SPLIT is None:
        return x
    return _GlobalSum.apply(x, _SPLIT)


def gather_rows(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' row blocks of ``x`` concatenated in rank order: the
    global batch's tensor on every rank (no gradient)."""
    if mesh.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.detach().contiguous(), group=mesh.group)
    return torch.cat(parts)


def rank_mean(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over ``mesh``'s ranks (no gradient)."""
    return all_sum(x, mesh) / mesh.size
