"""Last/best checkpoints of the 3D trainer (the JAX package's
``train/checkpoint.py``), on the standard-library msgpack of
``utils/flax_msgpack.py``.

The file layout is flax's ``msgpack_serialize(to_state_dict(state))``:
a map of maps whose leaves are arrays, numpy or Python scalars, strings,
None and empty maps; lists and tuples become maps keyed "0", "1", … as flax
writes them.  So the port reads the checkpoints the JAX package writes
(``model_state_dict.params`` plus whatever the optimizer state holds) and
the JAX package reads the port's.  Tensors are written as numpy arrays
(bfloat16 as float32, which numpy can hold).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict

import numpy as np
import torch

from ..logging_utils import get_logger
from ..utils import flax_msgpack

logger = get_logger("CheckpointUtils")

LAST_NAME = "last_checkpoint.msgpack"
BEST_NAME = "best_checkpoint.msgpack"


def _to_state_dict(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(tree, dict):
        return {str(k): _to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, (np.ndarray, np.generic, int, float, bool, str,
                         bytes)) or tree is None:
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def save_checkpoint(state: Dict[str, Any], is_best: bool,
                    checkpoint_dir: str) -> str:
    """Write ``last_checkpoint``; copy it to ``best_checkpoint`` when best."""
    if not os.path.exists(checkpoint_dir):
        logger.info(
            f"Checkpoint directory does not exist. Creating {checkpoint_dir}")
        os.makedirs(checkpoint_dir, exist_ok=True)
    last_file_path = os.path.join(checkpoint_dir, LAST_NAME)
    flax_msgpack.save(last_file_path, _to_state_dict(state))
    if is_best:
        shutil.copyfile(last_file_path, os.path.join(checkpoint_dir, BEST_NAME))
    return last_file_path


def load_checkpoint(checkpoint_path: str) -> Dict[str, Any]:
    """The checkpoint's tree: dicts with numpy arrays and scalars."""
    if not os.path.exists(checkpoint_path):
        raise IOError(f"Checkpoint '{checkpoint_path}' does not exist")
    return flax_msgpack.load(checkpoint_path)
