"""Last/best checkpoints on ``torch.distributed.checkpoint``: the port's
sharded checkpoints, in the place of the JAX package's
``train/orbax_ckpt.py`` ``OrbaxCheckpointer`` (the card's machine has no
orbax; the port's ``train/orbax_ckpt.py`` reads the JAX package's orbax
checkpoints and writes none).

The contract is the JAX checkpointer's: ``save(state, is_best=)`` writes
``<dir>/last`` and duplicates it into ``<dir>/best`` when best;
``restore(template=None, best=)`` reads one back; ``exists(best=)``.
Each process writes its part (replicated tensors once), and a checkpoint
appears whole or not at all: it is written into a temporary directory,
the processes meet at a barrier, and the primary renames it into place.

``state`` is a tree of dicts whose leaves are tensors, numpy arrays or
scalars, or other picklable values (numbers, strings, None, empty dicts).
Its paths are flattened to ``/``-joined keys, so a key may not hold a
``/``.  ``restore`` without a template gives numpy arrays for the tensor
leaves, as ``train/checkpoint.py``'s msgpack loader does; with one, the
template's tensors and arrays are filled in place and returned in its
shape.

Sharded state (channel tensor parallelism, ZeRO-1): a leaf that is a
``DTensor`` (``sharded``: this rank's block with its ``Shard(dim)``
placements on the (data, model) ``device_mesh``) is written by every rank
as its block, once per block; a plain tensor is replicated and written
once.  ``restore`` fills a ``DTensor`` leaf of the template with this
rank's block, and gives a plain template leaf, or no template, the whole
tensor, whichever layout wrote it.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.default_planner import (
    DefaultLoadPlanner,
    DefaultSavePlanner,
)
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..logging_utils import get_logger
from ..parallel.mesh import DataMesh

logger = get_logger("DistCheckpointer")

LAST_DIR = "last"
BEST_DIR = "best"
SEP = "/"
METADATA = ".metadata"  # what torch.distributed.checkpoint writes last


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        k = str(k)
        if SEP in k:
            raise ValueError(f"checkpoint key {k!r} holds {SEP!r}")
        if isinstance(v, dict) and v:
            flat.update(_flatten(v, prefix + k + SEP))
        elif isinstance(v, (np.ndarray, np.generic)):
            flat[prefix + k] = torch.from_numpy(np.array(v))
        else:
            flat[prefix + k] = v
    return flat


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *parents, leaf = key.split(SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _fill(template: Any, loaded: Any) -> Any:
    """``template``'s tree with its leaves taken from ``loaded``: tensors
    and arrays copied into in place (a ``DTensor`` is loaded in place
    already), other leaves replaced."""
    if isinstance(template, dict) and template:
        return {k: _fill(v, loaded[str(k)]) for k, v in template.items()}
    if isinstance(template, DTensor):
        return template
    if isinstance(template, torch.Tensor):
        template.copy_(loaded)
        return template
    if isinstance(template, np.ndarray):
        template[...] = loaded.numpy()
        return template
    if isinstance(template, np.generic):
        return type(template)(loaded.item())
    return loaded


def device_mesh(mesh: DataMesh):
    """The (data, model) ``DeviceMesh`` of ``mesh``'s layout, on the CPU
    (the blocks are written from host copies); it makes process groups, so
    every process calls it, and a caller keeps it."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (mesh.size, mesh.model_size),
                            mesh_dim_names=("data", "model"))


def sharded(local: torch.Tensor, dmesh, data_dim: Optional[int] = None,
            model_dim: Optional[int] = None):
    """This rank's block ``local`` of a tensor split evenly along
    ``data_dim`` over the data axis and ``model_dim`` over the model axis
    (None: replicated on that axis), as a leaf of a sharded checkpoint: a
    ``DTensor`` on a host copy, or ``local`` itself when it is replicated
    on both axes."""
    if data_dim is None and model_dim is None:
        return local
    placements = [Replicate() if d is None else Shard(d)
                  for d in (data_dim, model_dim)]
    return DTensor.from_local(local.detach().cpu().clone(), dmesh,
                              placements, run_check=False)


def is_checkpoint(path: str) -> bool:
    """``path`` is a torch.distributed.checkpoint directory (it holds the
    metadata written last)."""
    return os.path.exists(os.path.join(path, METADATA))


def _commit(tmp: str, path: str) -> None:
    """Swap ``tmp`` into ``path``: the old checkpoint is moved aside
    before the rename and removed after it."""
    old = path + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


class DistCheckpointer:
    def __init__(self, checkpoint_dir: str):
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        os.makedirs(self.checkpoint_dir, exist_ok=True)

    def _path(self, best: bool) -> str:
        return os.path.join(self.checkpoint_dir,
                            BEST_DIR if best else LAST_DIR)

    def save(self, state: Dict[str, Any], *, is_best: bool = False) -> str:
        """Write the ``last`` checkpoint; duplicate it into ``best`` when
        best.  Every process of the group calls it."""
        last = self._path(False)
        tmp = last + ".tmp"
        logger.info(f"Saving checkpoint to '{last}'")
        if _is_primary():
            shutil.rmtree(tmp, ignore_errors=True)
        _barrier()
        dcp.save(_flatten(state), checkpoint_id=tmp,
                 planner=DefaultSavePlanner(
                     flatten_state_dict=False, flatten_sharded_tensors=False),
                 no_dist=not dist.is_initialized())
        _barrier()
        if _is_primary():
            _commit(tmp, last)
            if is_best:
                best_tmp = self._path(True) + ".tmp"
                shutil.rmtree(best_tmp, ignore_errors=True)
                shutil.copytree(last, best_tmp)
                _commit(best_tmp, self._path(True))
        _barrier()
        return last

    def restore(self, template: Optional[Dict[str, Any]] = None, *,
                best: bool = False) -> Dict[str, Any]:
        path = self._path(best)
        if not os.path.exists(path):
            raise IOError(f"Checkpoint '{path}' does not exist")
        if not is_checkpoint(path):
            raise ValueError(
                f"'{path}' holds no torch.distributed.checkpoint metadata; "
                "an orbax checkpoint of the JAX package is read by "
                "train/orbax_ckpt.py's OrbaxCheckpointer")
        meta = dcp.FileSystemReader(path).read_metadata()
        blocks = ({} if template is None else
                  {k: v for k, v in _flatten(template).items()
                   if isinstance(v, DTensor)})
        flat = {}
        for key, m in meta.state_dict_metadata.items():
            flat[key] = (blocks[key] if key in blocks else
                         torch.empty(tuple(m.size), dtype=m.properties.dtype)
                         if isinstance(m, dcp.TensorStorageMetadata)
                         else None)
        dcp.load(flat, checkpoint_id=path,
                 planner=DefaultLoadPlanner(
                     flatten_state_dict=False, flatten_sharded_tensors=False),
                 no_dist=not dist.is_initialized())
        loaded = _unflatten(flat)
        if template is not None:
            return _fill(template, loaded)

        def numpy(t):
            if isinstance(t, dict):
                return {k: numpy(v) for k, v in t.items()}
            return t.numpy() if isinstance(t, torch.Tensor) else t

        return numpy(loaded)

    def exists(self, best: bool = False) -> bool:
        return os.path.exists(self._path(best))
