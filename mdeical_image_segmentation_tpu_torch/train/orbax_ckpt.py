"""The JAX package's orbax checkpoints, read (``train/orbax_ckpt.py``'s
``OrbaxCheckpointer`` of the JAX package, read-only): the JAX 3D trainer
writes one whenever a run is tensor-parallel or ZeRO-1
(``<checkpoint_dir>/orbax/{last,best}``), and ``resume: <dir>/orbax``
continues such a run in the port.

The contract is the JAX checkpointer's: ``restore(template=None, best=)``
reads ``<dir>/last`` (``<dir>/best`` with ``best``) and raises ``IOError``
where it does not exist; ``exists(best=)``.  Writing is not ported: the
port's TP and ZeRO-1 runs write ``train/dist_ckpt.py`` checkpoints.

A checkpoint directory holds ``_METADATA`` (JSON): ``tree_metadata`` maps
each leaf to its path (``key_metadata``: dict keys and sequence indices)
and its ``value_type``; ``use_ocdbt`` says where the leaves are.  Each leaf
with data is a zarr v2 array (``utils/zarr2.py``) named by its path's keys
joined with ``.``: in the OCDBT database of the directory
(``utils/ocdbt.py``; orbax's root manifest points into the
``ocdbt.process_<i>`` databases its processes wrote, whatever their
number), or, with ``use_ocdbt: false``, in a directory of its own.

The tree is rebuilt as the msgpack loader (``train/checkpoint.py``) gives
a JAX checkpoint: nested dicts with string keys, sequences as dicts keyed
``"0"``, ``"1"``, ...; ``np.ndarray`` and ``jax.Array`` leaves as numpy
arrays, ``scalar`` leaves as numpy scalars, empty containers (orbax's
``skip_deserialize`` ``Dict``, ``List`` and ``Tuple``) as ``{}`` and
``None`` as None.  With a template the result takes its shape: its
tensors, arrays and numbers come back as the same types and dtypes.
``use_zarr3: true``, another value type or another array format raises
``ValueError`` naming ROADMAP item 19b.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from ..utils import zarr2
from ..utils.ocdbt import KvStore
from .logging_utils import get_logger

logger = get_logger("OrbaxCheckpointer")

LAST_DIR = "last"
BEST_DIR = "best"
METADATA = "_METADATA"
ITEM = "ROADMAP item 19b"
ARRAYS = ("np.ndarray", "jax.Array", "scalar")
EMPTY = ("Dict", "List", "Tuple")


def is_checkpoint(path: str) -> bool:
    """``path`` is an orbax checkpoint directory (it holds ``_METADATA``)."""
    return os.path.isfile(os.path.join(path, METADATA))


def _store(path: str, meta: Dict[str, Any]):
    """``get(key)``: the bytes under a key of the checkpoint's arrays, or
    None."""
    if meta.get("use_zarr3"):
        raise ValueError(f"'{path}' holds zarr v3 arrays (use_zarr3), which "
                         f"are not read ({ITEM})")
    if meta.get("use_ocdbt", False):
        kv = KvStore(path)
        return lambda key: kv.read(key) if key in kv else None

    def get(key: str) -> Optional[bytes]:
        full = os.path.join(path, *key.split("/"))
        if not os.path.isfile(full):
            return None
        with open(full, "rb") as f:
            return f.read()

    return get


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The tree of the orbax checkpoint directory ``path``."""
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    get = _store(path, meta)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if kind in ARRAYS and not value.get("skip_deserialize"):
            leaf = zarr2.read_array(get, ".".join(keys))
            if kind == "scalar":
                leaf = leaf[()]
        elif kind == "None":
            leaf = None
        elif kind in EMPTY:
            leaf = {}
        else:
            raise ValueError(f"'{path}': leaf {'.'.join(keys)} of type "
                             f"{kind!r} is not read ({ITEM})")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def _fit(template: Any, value: Any, where: str) -> Any:
    """``value`` in the shape and types of ``template``."""
    import torch

    if isinstance(template, dict):
        if not isinstance(value, dict):
            raise ValueError(f"{where}: the checkpoint has no tree here")
        missing = set(template) - set(value)
        if missing:
            raise KeyError(f"{where}: not in the checkpoint: {sorted(missing)}")
        return {k: _fit(v, value[k], f"{where}.{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_fit(v, value[str(i)], f"{where}.{i}")
                              for i, v in enumerate(template))
    if template is None or value is None:
        return value
    if isinstance(template, torch.Tensor):
        got = torch.as_tensor(np.asarray(value))
        if tuple(got.shape) != tuple(template.shape):
            raise ValueError(f"{where}: shape {tuple(got.shape)}, the "
                             f"template's {tuple(template.shape)}")
        return got.to(device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        got = np.asarray(value)
        if got.shape != template.shape:
            raise ValueError(f"{where}: shape {got.shape}, the template's "
                             f"{template.shape}")
        return got.astype(template.dtype, copy=False)
    if isinstance(template, np.generic):
        return template.dtype.type(value)
    return type(template)(value)


class OrbaxCheckpointer:
    def __init__(self, checkpoint_dir: str):
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)

    def _path(self, best: bool) -> str:
        return os.path.join(self.checkpoint_dir, BEST_DIR if best else LAST_DIR)

    def restore(self, template: Optional[Dict[str, Any]] = None, *,
                best: bool = False) -> Dict[str, Any]:
        path = self._path(best)
        if not os.path.exists(path):
            raise IOError(f"Checkpoint '{path}' does not exist")
        logger.info(f"Reading orbax checkpoint '{path}'")
        tree = read_checkpoint(path)
        return tree if template is None else _fit(template, tree, "state")

    def exists(self, best: bool = False) -> bool:
        return os.path.exists(self._path(best))
