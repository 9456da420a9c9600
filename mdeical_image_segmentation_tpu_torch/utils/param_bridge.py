"""Parameter bridge: the JAX package's flax tree ↔ the port's ``state_dict``.

The inverse of the JAX package's ``utils/torch_import.py`` converters
(``convert_conv``, ``convert_conv_transpose``), generic over the tree:

- ``<path>/Conv_0/kernel`` (HWIO) ↔ ``<path>.weight`` (OIHW), and
  ``<path>/Conv_0/bias`` ↔ ``<path>.bias``;
- ``<path>/ConvTranspose_0/kernel`` (flax ``(kh, kw, I, O)``, a
  cross-correlation) ↔ ``<path>.weight`` (torch ``(I, O, kh, kw)``, which
  scatters the kernel): the spatial taps are flipped;

where ``<path>`` joins the module names with ``/`` in flax and ``.`` in
torch (``DoubleConvolution_3/TorchConv_1`` ↔ ``DoubleConvolution_3.
TorchConv_1``).  Values are numpy arrays on the flax side and tensors (or
numpy arrays) on the torch side; both directions copy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_INNER = {"Conv_0": False, "ConvTranspose_0": True}  # name -> is transposed


def _leaves(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v)


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": tree}`` (or the bare params tree) → torch ``state_dict``."""
    params = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        if len(path) < 3 or path[-2] not in _INNER or path[-1] not in (
                "kernel", "bias"):
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
        a = np.asarray(value)
        if path[-1] == "kernel":
            if _INNER[path[-2]]:  # (kh, kw, I, O) -> flip taps -> (I, O, kh, kw)
                a = np.transpose(np.flip(a, (0, 1)), (2, 3, 0, 1))
            else:                 # HWIO -> OIHW
                a = np.transpose(a, (3, 2, 0, 1))
        key = ".".join(path[:-2]) + (".weight" if path[-1] == "kernel"
                                     else ".bias")
        sd[key] = torch.from_numpy(np.array(a, order="C"))  # a copy
    return sd


def state_dict_to_flax(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """torch ``state_dict`` → ``{"params": tree}`` of float32 numpy arrays,
    in the order of ``sd`` (module registration order)."""
    params: Dict[str, Any] = {}
    for key, value in sd.items():
        *mods, name = key.split(".")
        if not mods or name not in ("weight", "bias"):
            raise ValueError(f"unexpected state_dict entry {key}")
        transposed = mods[-1].startswith("TorchConvTranspose")
        a = _to_numpy(value)
        if name == "weight":
            if transposed:  # (I, O, kh, kw) -> (kh, kw, I, O) -> flip taps
                a = np.flip(np.transpose(a, (2, 3, 0, 1)), (0, 1))
            else:           # OIHW -> HWIO
                a = np.transpose(a, (2, 3, 1, 0))
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        inner = node.setdefault(
            "ConvTranspose_0" if transposed else "Conv_0", {})
        inner["kernel" if name == "weight" else "bias"] = np.ascontiguousarray(a)
    return {"params": params}
