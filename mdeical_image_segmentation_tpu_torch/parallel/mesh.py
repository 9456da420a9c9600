"""The (data, model) mesh of a distributed run (the JAX package's
``parallel/mesh.py``).

The JAX package trains one GSPMD program over a device mesh, "as if on one
big device": the global batch is sharded over the ``data`` axis, so every
batch statistic (BatchNorm's, a Dice ratio's, an eval sum) is the global
batch's, and the ``model`` axis shards conv out-channels (channel tensor
parallelism, ``parallel/tensor.py``).  The port runs one process per
device.  ``make_mesh(n_data, n_model)`` lays the processes out as JAX's
``reshape(n_data, n_model)`` does: rank r sits at (r // n_model,
r % n_model), and every axis gets its own process groups.  A ``DataMesh``
is this process's view: its data index and the data axis's group
(``rank``, ``size``, ``group``: what DDP, the loaders and every global
statistic use), its model index and the model axis's group
(``model_rank``, ``model_size``, ``model_group``), and its device.  Ranks
that share a data index hold the same rows and draw the same random
streams; ``shard_batch`` gives a data index the rows the JAX mesh puts on
its devices, ``[rank·local : (rank+1)·local]`` of the global batch, or the
whole batch when its rows do not divide (JAX replicates such a tail).

Global statistics: while a batch's rows are split over the data axis
(inside ``rows_split(mesh)``), ``global_sum`` adds a per-rank partial sum
over the data group, differentiably, and BatchNorm reduces its statistics
the same way (``ops/batchnorm.py``).  Outside it, and on a replicated tail
that every rank holds whole, they are local: all-reducing a replicated
batch would count it ``size`` times, and reducing over the model axis would
count every row ``model_size`` times.  The split is process-wide state,
not a context variable, because a rematerialized block runs again inside
the backward, on the autograd engine's thread.  Spatial sharding splits
one volume over the ranks of a data-only mesh (``parallel/spatial.py``).
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


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process on a (data, model) mesh: data index ``rank`` of
    ``size`` on the data axis (its ranks in ``group``), model index
    ``model_rank`` of ``model_size`` (``model_group``), on ``device``.  A
    group None is the default process group (or none, for a size of 1
    without one)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None
    model_size: int = 1
    model_rank: int = 0
    model_group: Optional[Any] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.size, MODEL_AXIS: self.model_size}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *,
              device: Union[str, torch.device] = "cuda") -> DataMesh:
    """The (``n_data``, ``n_model``) mesh over every process of the group
    (one process when there is none), on this process's ``device``: the
    current card by default, ``"cpu"`` when asked.  ``n_data`` None takes
    the processes that ``n_model`` leaves; the axes must cover the group
    exactly (one process per device).  Every process calls it, in the same
    order as any other group it makes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n_model = int(n_model)
    if n_model < 1 or world % n_model:
        raise ValueError(f"make_mesh(n_model={n_model}): a model axis must "
                         f"divide the {world} processes (one process per "
                         "device)")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"make_mesh(n_data={n_data}, n_model={n_model}): "
                         f"the port runs one process per device and this "
                         f"group has {world}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda') needs a CUDA card; "
                               "pass device='cpu' on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    if n_model == 1:
        return DataMesh(world, rank, device)
    d, m = divmod(rank, n_model)
    data_group = model_group = None
    # every process makes every group, in one order
    for j in range(n_model):
        g = dist.new_group([i * n_model + j for i in range(n_data)])
        if j == m:
            data_group = g
    for i in range(n_data):
        g = dist.new_group([i * n_model + j for j in range(n_model)])
        if i == d:
            model_group = g
    return DataMesh(n_data, d, device, data_group, n_model, m, model_group)


def group_src(group: Any, index: int = 0) -> int:
    """The global rank of ``group``'s rank ``index`` (``index`` itself for
    the default group)."""
    return index if group is None else dist.get_global_rank(group, index)


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
    leaves are sent as objects) as data index 0 holds it, on every rank of
    the data axis.  Tensors are overwritten in place."""
    if mesh.size == 1:
        return tree
    src = group_src(mesh.group)
    objects = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            dist.broadcast(t, src=src, group=mesh.group)
            return t
        if isinstance(t, np.ndarray):
            buf = torch.from_numpy(np.ascontiguousarray(t)).to(mesh.device)
            dist.broadcast(buf, src=src, group=mesh.group)
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
    dist.broadcast_object_list(objects, src=src, group=mesh.group)

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
             find_unused_parameters: bool = False,
             mesh: Optional[DataMesh] = None) -> torch.nn.Module:
    """``model`` under DDP when a process group is up, else ``model``: over
    the whole group (a data-only ``mesh``, or none; a world of 1 too), or
    over the data axis of a mesh with a model axis, when that has more
    than one rank.  Its parameters are broadcast from data index 0 and its
    gradients averaged over the data axis (a tensor-parallel shard with the
    ranks of its own model index).  The buffers are not broadcast:
    BatchNorm's running statistics are updated from the global batch's
    statistics, the same on every rank."""
    if not dist.is_initialized() or (mesh is not None and mesh.model_size > 1
                                     and mesh.size == 1):
        return model
    ids = ([device.index if device.index is not None
            else torch.cuda.current_device()] if device.type == "cuda"
           else None)
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=ids, broadcast_buffers=False,
        find_unused_parameters=find_unused_parameters,
        process_group=None if mesh is None else mesh.group)


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


def all_gather_dim(x: torch.Tensor, dim: int, group: Any, size: int
                   ) -> torch.Tensor:
    """The ``size`` ranks' blocks of ``x`` in ``group`` concatenated along
    ``dim`` in rank order, on every rank (no gradient).  NCCL gathers into
    one tensor; gloo has no all-gather of CUDA tensors, so under gloo a
    CUDA block goes through the host (gloo serves only to share one card
    between ranks; NCCL is the path between cards)."""
    if size == 1:
        return x
    x = x.detach().contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((size, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        src = x.cpu()
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        out = torch.stack(parts).to(x.device)
    shape = list(x.shape)
    shape[dim] *= size
    return out.movedim(0, dim).reshape(shape)


def gather_rows(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """The data axis's row blocks of ``x`` concatenated in rank order: the
    global batch's tensor on every rank (no gradient)."""
    return all_gather_dim(x, 0, mesh.group, mesh.size)


def rank_mean(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over ``mesh``'s ranks (no gradient)."""
    return all_sum(x, mesh) / mesh.size
