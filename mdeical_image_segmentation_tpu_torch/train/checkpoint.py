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

The optimizer state of ``torch.optim.Adam`` is written in the layout the JAX
trainer writes for its Adam, ``inject_hyperparams(chain(add_decayed_weights,
adam))`` (``chain`` only when the weight decay is not 0)::

    {"count": int32, "hyperparams": {"learning_rate": float32},
     "hyperparams_states": {},
     "inner_state": {"0": {}, "1": {"0": ADAM, "1": {}}}}   # weight decay
     "inner_state": {"0": ADAM, "1": {}}                     # none
    ADAM = {"count": int32, "mu": <params tree>, "nu": <params tree>}

with torch's ``exp_avg`` / ``exp_avg_sq`` / ``step`` as ``mu`` / ``nu`` /
``count`` and the moments mapped leaf for leaf by the parameter bridge, so
a JAX checkpoint resumes in the port and the port's in the JAX package.
Other optimizers save their per-parameter state by parameter name and
resume within the port only.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict

import numpy as np
import torch

from ..logging_utils import get_logger
from ..utils import flax_msgpack
from ..utils.param_bridge import flax_to_state_dict, state_dict_to_flax

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


def _scalar(v, dtype) -> np.ndarray:
    return np.asarray(v, dtype=dtype).reshape(())


def optimizer_state_tree(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module) -> Dict[str, Any]:
    """The optimizer's state as a checkpoint tree (see the module doc)."""
    named = list(model.named_parameters())
    lr = optimizer.param_groups[0]["lr"]
    if type(optimizer) is not torch.optim.Adam:
        state = {}
        for name, p in named:
            entries = {k: (v.item() if k == "step" else v)
                       for k, v in optimizer.state.get(p, {}).items()
                       if v is not None}
            if entries:
                state[name] = entries
        return {"torch_optimizer": type(optimizer).__name__,
                "learning_rate": float(lr), "state": state}
    step, mu, nu = 0, {}, {}
    for name, p in named:
        st = optimizer.state.get(p, {})
        if "step" in st:
            step = int(st["step"])
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
    adam = {"count": _scalar(step, np.int32),
            "mu": state_dict_to_flax(mu)["params"],
            "nu": state_dict_to_flax(nu)["params"]}
    if optimizer.param_groups[0]["weight_decay"]:
        inner = {"0": {}, "1": {"0": adam, "1": {}}}
    else:
        inner = {"0": adam, "1": {}}
    return {"count": _scalar(step, np.int32),
            "hyperparams": {"learning_rate": _scalar(lr, np.float32)},
            "hyperparams_states": {}, "inner_state": inner}


def _find_adam(tree: Any) -> Dict[str, Any]:
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for v in tree.values():
            found = _find_adam(v)
            if found is not None:
                return found
    return None


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Restore what :func:`optimizer_state_tree` (or the JAX trainer, for
    Adam) wrote into ``optimizer``, whose params are ``model``'s."""
    named = list(model.named_parameters())
    if "torch_optimizer" in tree:
        if tree["torch_optimizer"] != type(optimizer).__name__:
            raise ValueError(f"checkpoint holds a {tree['torch_optimizer']} "
                             f"state, the optimizer is "
                             f"{type(optimizer).__name__}")
        for name, p in named:
            entries = tree["state"].get(name)
            if entries:
                optimizer.state[p] = {
                    k: (torch.tensor(float(v), dtype=torch.float32)
                        if k == "step" else
                        torch.as_tensor(np.asarray(v)).to(p.device, p.dtype))
                    for k, v in entries.items()}
        return
    if type(optimizer) is not torch.optim.Adam:
        raise ValueError("a checkpoint in the JAX Adam layout resumes only "
                         "into torch.optim.Adam")
    adam = _find_adam(tree.get("inner_state"))
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the checkpoint's "
                         "optimizer_state_dict")
    mu, nu = flax_to_state_dict(adam["mu"]), flax_to_state_dict(adam["nu"])
    step = float(np.asarray(adam["count"]))
    for name, p in named:
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype)}
