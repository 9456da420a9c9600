"""Parameter bridge: the JAX package's flax tree ↔ the port's ``state_dict``.

The inverse of the JAX package's ``utils/torch_import.py`` converters
(``convert_conv``, ``convert_conv_transpose``), generic over the tree and
over 2D and 3D kernels:

- ``<path>/Conv_0/kernel`` (flax ``(*k, I, O)``: HWIO or DHWIO) ↔
  ``<path>.weight`` (torch ``(O, I, *k)``: OIHW or OIDHW), and
  ``<path>/Conv_0/bias`` ↔ ``<path>.bias``;
- ``<path>/ConvTranspose_0/kernel`` (flax ``(*k, I, O)``, a
  cross-correlation) ↔ ``<path>.weight`` (torch ``(I, O, *k)``, which
  scatters the kernel): the spatial taps are flipped along every axis;
- ``<path>/GroupNorm_0/{scale,bias}`` ↔ ``<path>.GroupNorm_0.{weight,bias}``
  (the fused 'gcr' path of the 3D blocks keeps these paths too);
- ``<path>/BatchNorm_0/{scale,bias}`` ↔ ``<path>.{weight,bias}`` of the
  ``TorchBatchNorm*`` module at ``<path>`` (the 2D layers), or of the
  module named ``BatchNorm_0`` at ``<path>.BatchNorm_0`` (the 3D blocks'
  SingleConv), and the ``batch_stats`` collection's
  ``<path>/BatchNorm_0/{mean,var}`` ↔ its ``running_mean`` /
  ``running_var`` buffers (a torch ``num_batches_tracked`` has no flax
  counterpart and is dropped);
- ``<path>/Dense_k/kernel`` (flax ``(in, out)``) ↔ ``<path>.Dense_k.weight``
  (torch ``(out, in)``), and ``<path>/Dense_k/bias`` ↔ its bias (the
  squeeze-excitation gates);

- SAM-Med2D's tree (``sam_flax_to_state_dict`` / ``sam_state_dict_to_flax``,
  below: flax names kept as module names, the leaves converted);

- the int8 PTQ ``quant`` collection's ``<path>/Conv_0/x_absmax`` ↔ the
  scales dict's ``<path>`` (``quant_to_torch`` / ``quant_to_flax``; the
  scales stay outside the ``state_dict``, see ``ops/quant.py``);

where ``<path>`` joins the module names with ``/`` in flax and ``.`` in
torch (``encoder0/basic_module/SingleConv1/TorchConv_0`` ↔ ``encoder0.
basic_module.SingleConv1.TorchConv_0``).  On the torch side a transposed
conv is a module named ``TorchConvTranspose*`` (the 2D UNet) or
``upsampling`` (the 3D decoders' ``TransposeConvUpsampling``).  Values are
numpy arrays on the flax side and tensors (or numpy arrays) on the torch
side; both directions copy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_INNER = {"Conv_0": False, "ConvTranspose_0": True}  # name -> is transposed
_GN = "GroupNorm_0"
_GN_LEAVES = {"scale": "weight", "bias": "bias"}  # flax -> torch
_BN = "BatchNorm_0"
_BN_STATS = {"mean": "running_mean", "var": "running_var"}  # flax -> torch
_BN_MODULE = "TorchBatchNorm"
_DENSE = "Dense_"


def _bn_module(path) -> str:
    """The torch module of the flax leaf ``<path>/BatchNorm_0/<leaf>``: the
    ``TorchBatchNorm*`` scope itself, else a child named ``BatchNorm_0``."""
    if len(path) >= 3 and path[-3].startswith(_BN_MODULE):
        return ".".join(path[:-2])
    return ".".join(path[:-1])


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


def _is_transposed(module_name: str) -> bool:
    return module_name.startswith("TorchConvTranspose") or (
        module_name == "upsampling")


def _kernel_to_torch(a: np.ndarray, transposed: bool) -> np.ndarray:
    sp = tuple(range(a.ndim - 2))
    if transposed:  # (*k, I, O) -> flip taps -> (I, O, *k)
        return np.transpose(np.flip(a, sp), (a.ndim - 2, a.ndim - 1, *sp))
    return np.transpose(a, (a.ndim - 1, a.ndim - 2, *sp))  # -> (O, I, *k)


def _kernel_to_flax(a: np.ndarray, transposed: bool) -> np.ndarray:
    sp = tuple(range(2, a.ndim))
    if transposed:  # (I, O, *k) -> (*k, I, O) -> flip taps
        return np.flip(np.transpose(a, (*sp, 0, 1)), tuple(range(a.ndim - 2)))
    return np.transpose(a, (*sp, 1, 0))  # (O, I, *k) -> (*k, I, O)


def flax_dim(key: str, dim: int, ndim: int) -> int:
    """The flax leaf's dim that dim ``dim`` of the ``state_dict`` entry
    ``key`` (of ``ndim`` dims) becomes: a conv's (O, I, *k) goes to
    (*k, I, O), a transposed conv's (I, O, *k) to (*k, I, O), a Dense's
    (out, in) to (in, out); vectors stay."""
    mods = key.split(".")[:-1]
    if ndim == 1:
        return dim
    if mods and mods[-1].startswith(_DENSE):
        return 1 - dim
    if dim >= 2:
        return dim - 2
    if _is_transposed(mods[-1] if mods else ""):
        return ndim - 2 + dim  # I -> ndim-2, O -> ndim-1
    return ndim - 1 - dim  # O -> ndim-1, I -> ndim-2


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": tree, "batch_stats": tree}`` (``batch_stats`` only with
    BatchNorm; or the bare params tree) → torch ``state_dict``."""
    params = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables.get("batch_stats", {})):
        if len(path) < 2 or path[-2] != _BN or path[-1] not in _BN_STATS:
            raise ValueError(f"unexpected batch_stats leaf {'/'.join(path)}")
        sd[_bn_module(path) + "." + _BN_STATS[path[-1]]] = (
            torch.from_numpy(np.array(value, dtype=np.float32, order="C")))
    for path, value in _leaves(params):
        a = np.asarray(value)
        if len(path) >= 2 and path[-2] == _BN and path[-1] in _GN_LEAVES:
            key = _bn_module(path) + "." + _GN_LEAVES[path[-1]]
        elif len(path) >= 2 and path[-2] == _GN and path[-1] in _GN_LEAVES:
            key = ".".join(path[:-1]) + "." + _GN_LEAVES[path[-1]]
        elif (len(path) >= 2 and path[-2].startswith(_DENSE)
              and path[-1] in ("kernel", "bias")):
            if path[-1] == "kernel":
                a = a.T
            key = ".".join(path[:-1]) + (".weight" if path[-1] == "kernel"
                                         else ".bias")
        elif (len(path) >= 3 and path[-2] in _INNER
              and path[-1] in ("kernel", "bias")):
            if path[-1] == "kernel":
                a = _kernel_to_torch(a, _INNER[path[-2]])
            key = ".".join(path[:-2]) + (".weight" if path[-1] == "kernel"
                                         else ".bias")
        else:
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
        sd[key] = torch.from_numpy(np.array(a, order="C"))  # a copy
    return sd


def _node(tree: Dict[str, Any], path) -> Dict[str, Any]:
    for m in path:
        tree = tree.setdefault(m, {})
    return tree


def state_dict_to_flax(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """torch ``state_dict`` → ``{"params": tree}`` of float32 numpy arrays,
    in the order of ``sd`` (module registration order), plus
    ``"batch_stats"`` when the model has BatchNorm."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, value in sd.items():
        *mods, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        bn = bool(mods) and (mods[-1].startswith(_BN_MODULE)
                             or mods[-1] == _BN)
        bn_path = (*mods, _BN) if bn and mods[-1] != _BN else tuple(mods)
        if bn and name in ("running_mean", "running_var"):
            _node(stats, bn_path)[
                "mean" if name == "running_mean" else "var"] = (
                    np.ascontiguousarray(_to_numpy(value)))
            continue
        if not mods or name not in ("weight", "bias"):
            raise ValueError(f"unexpected state_dict entry {key}")
        a = _to_numpy(value)
        if bn:
            _node(params, bn_path)[
                "scale" if name == "weight" else "bias"] = (
                    np.ascontiguousarray(a))
            continue
        if mods[-1].startswith(_DENSE):
            _node(params, mods)["kernel" if name == "weight" else "bias"] = (
                np.ascontiguousarray(a.T if name == "weight" else a))
            continue
        if mods[-1] == _GN:
            _node(params, mods)["scale" if name == "weight" else "bias"] = (
                np.ascontiguousarray(a))
            continue
        transposed = _is_transposed(mods[-1])
        if name == "weight":
            a = _kernel_to_flax(a, transposed)
        inner = _node(params, (*mods, "ConvTranspose_0" if transposed
                               else "Conv_0"))
        inner["kernel" if name == "weight" else "bias"] = np.ascontiguousarray(a)
    if stats:
        return {"params": params, "batch_stats": stats}
    return {"params": params}


_ABSMAX = "x_absmax"


def quant_to_torch(quant: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"quant": tree}`` (or the bare tree) → the port's
    scales dict ``{module path: 0-d float32 tensor}``."""
    scales: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(quant.get("quant", quant)):
        if len(path) < 3 or path[-2] != "Conv_0" or path[-1] != _ABSMAX:
            raise ValueError(f"unexpected quant leaf {'/'.join(path)}")
        scales[".".join(path[:-2])] = torch.tensor(
            np.asarray(value, dtype=np.float32))
    return scales


def quant_to_flax(scales: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's scales dict → ``{"quant": tree}`` of float32 numpy
    scalars, as the JAX package's ``calibrate`` returns it."""
    tree: Dict[str, Any] = {}
    for key, value in scales.items():
        _node(tree, (*key.split("."), "Conv_0"))[_ABSMAX] = np.asarray(
            _to_numpy(value), dtype=np.float32)
    return {"quant": tree}


# -- SAM-Med2D (models/sam.py) ------------------------------------------------
#
# The port's SAM modules keep the flax module names as attribute names, so a
# state_dict key is the flax path joined with dots and only the leaves
# change: ``kernel`` ↔ ``weight`` (a Dense ``(in, out)`` ↔ ``(out, in)``; a
# Conv HWIO ↔ OIHW; a ``ConvTranspose_k`` HWIO ↔ IOHW with its taps
# flipped), LayerNorm ``scale`` ↔ ``weight``, ``bias`` ↔ ``bias``, and the
# raw parameters (``pos_embed``, ``pe_gaussian``, ``point_embeddings``,
# ``no_mask_embed``, ``iou_token``, ``mask_tokens``) as they are.
_SAM_TRANSPOSED = "ConvTranspose_"


def _sam_kernel_to_torch(path, a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:  # Dense
        return a.T
    return _kernel_to_torch(a, path[-2].startswith(_SAM_TRANSPOSED))


def sam_flax_to_state_dict(variables: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """A SAM ``{"params": tree}`` (or the bare tree) → the port's
    ``SAMMed2D`` ``state_dict``; exact."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables.get("params", variables)):
        a = np.asarray(value)
        leaf = path[-1]
        if leaf == "kernel":
            a, leaf = _sam_kernel_to_torch(path, a), "weight"
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join((*path[:-1], leaf))] = torch.from_numpy(
            np.array(a, order="C"))  # a copy
    return sd


def sam_state_dict_to_flax(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's ``SAMMed2D`` ``state_dict`` → ``{"params": tree}`` of
    float32 numpy arrays; exact.  A 1-D ``weight`` is a LayerNorm's scale;
    a 2-D one a Dense kernel; a 4-D one a conv's (transposed under a
    ``ConvTranspose_k``)."""
    params: Dict[str, Any] = {}
    for key, value in sd.items():
        *mods, name = key.split(".")
        a = _to_numpy(value)
        if name == "weight":
            if a.ndim == 1:
                name = "scale"
            elif a.ndim == 2:
                a, name = a.T, "kernel"
            else:
                a = _kernel_to_flax(a, mods[-1].startswith(_SAM_TRANSPOSED))
                name = "kernel"
        _node(params, mods)[name] = np.ascontiguousarray(a)
    return {"params": params}
