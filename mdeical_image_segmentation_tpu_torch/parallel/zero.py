"""ZeRO-1: the optimizer state sharded over the mesh's ``data`` axis (the
JAX package's ``parallel/zero.py``).

The JAX package partitions the optimizer moments over ``data`` with
sharding annotations (``zero1_specs``: each leaf's largest dim that is not
sharded already and divides by the axis, composed with the tensor-parallel
spec as ``base``) and lets XLA gather the updates.  The port places it by
hand: ``Zero1Optimizer`` keeps, for every parameter with such a dim, this
data index's contiguous slice of it as a tensor of its own, and runs the
inner optimizer (``torch.optim.Adam`` / ``AdamW`` / ``SGD`` or an optax
rule of ``train/optimizers.py``) on the slices only, so its state (the
moments) exists only for the slices; after the step the updated slices are
all-gathered into the whole parameters over the data group.  Parameters
with no such dim, and scalars, stay whole on every rank and are updated
there.  It runs after the gradients are averaged over the data axis (DDP)
and clipped, so every optimizer that is elementwise gives the replicated
run's parameters to the bit; LBFGS's step raises as it does replicated.
The parameters stay replicated over ``data`` (ZeRO-1, not ZeRO-3).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .mesh import DATA_AXIS, MODEL_AXIS, DataMesh, all_gather_dim

Spec = Tuple[Optional[str], ...]


def leaf_spec(shape: Sequence[int], n: int, base: Optional[Spec] = None,
              order: Optional[Sequence[int]] = None) -> Spec:
    """The JAX package's ``_leaf_spec``: ``base`` (None entries where it is
    unsharded) with ``"data"`` on the largest dim that ``base`` leaves
    unsharded and ``n`` divides (the first of equal ones, in ``order``:
    the dims as the flax leaf lays them out, default 0, 1, ...).  A
    scalar, or a leaf with no such dim, keeps ``base``."""
    shape = tuple(shape)
    entries = list(base) if base is not None else []
    entries += [None] * (len(shape) - len(entries))
    best, best_extent = None, 0
    for i in (order if order is not None else range(len(shape))):
        extent = shape[i]
        if entries[i] is None and extent % n == 0 and extent >= n:
            if extent > best_extent:
                best, best_extent = i, extent
    if best is not None:
        entries[best] = DATA_AXIS
    return tuple(entries)


def zero1_specs(tree: Dict[str, Any], n: int,
                base_specs: Optional[Dict[str, Spec]] = None
                ) -> Dict[str, Spec]:
    """{key: spec} of a flat dict of arrays or tensors: every leaf sharded
    over ``n`` ranks of the data axis where it can be."""
    base_specs = base_specs or {}
    return {k: leaf_spec(tuple(v.shape), n, base_specs.get(k))
            for k, v in tree.items()}


def _flax_order(name: str, ndim: int) -> List[int]:
    """The port's dims of parameter ``name`` in the flax leaf's order."""
    from ..utils.param_bridge import flax_dim

    where = {flax_dim(name, d, ndim): d for d in range(ndim)}
    return [where[i] for i in range(ndim)]


class Zero1Optimizer:
    """``inner`` (built on ``model``'s parameters, its state empty or whole)
    with its state sharded over ``mesh``'s data axis.  ``step`` takes the
    whole averaged gradients of the parameters and leaves the whole updated
    parameters; ``param_groups`` and ``state`` are the inner optimizer's
    (the state keyed by the slices)."""

    def __init__(self, inner: torch.optim.Optimizer, model: nn.Module,
                 mesh: DataMesh):
        from .tensor import sharded_dims

        self.inner, self.mesh = inner, mesh
        n, r = mesh.size, mesh.rank
        names = {id(p): k for k, p in model.named_parameters()}
        tp_dims = sharded_dims(model)
        # (parameter, its slice, the data-axis dim or None, name)
        self.entries: List[Tuple[torch.Tensor, torch.Tensor, Optional[int],
                                 str]] = []
        for group in inner.param_groups:
            slices = []
            for p in group["params"]:
                name = names[id(p)]
                base = tuple(MODEL_AXIS if d == tp_dims.get(name) else None
                             for d in range(p.ndim))
                spec = leaf_spec(p.shape, n, base,
                                 order=_flax_order(name, p.ndim))
                dim = next((i for i, a in enumerate(spec) if a == DATA_AXIS),
                           None)
                s = p
                if dim is not None:
                    block = p.shape[dim] // n
                    s = p.detach().narrow(dim, r * block, block).clone()
                    state = inner.state.pop(p, None)
                    if state:
                        inner.state[s] = {
                            k: (v.narrow(dim, r * block, block).clone()
                                if isinstance(v, torch.Tensor)
                                and v.shape == p.shape else v)
                            for k, v in state.items()}
                self.entries.append((p, s, dim, name))
                slices.append(s)
            group["params"] = slices

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p, s, dim, _ in self.entries:
            p.grad = None
            if dim is not None:
                s.grad = None

    @torch.no_grad()
    def step(self, closure=None):
        n, r = self.mesh.size, self.mesh.rank
        for p, s, dim, _ in self.entries:
            if dim is not None:
                block = p.shape[dim] // n
                s.grad = (None if p.grad is None else
                          p.grad.narrow(dim, r * block, block).contiguous())
        loss = self.inner.step(closure)
        for p, s, dim, _ in self.entries:
            if dim is not None:
                p.copy_(all_gather_dim(s, dim, self.mesh.group, n))
                s.grad = None
        return loss

    def state_bytes(self) -> int:
        """The bytes of the optimizer state this rank holds."""
        return sum(v.numel() * v.element_size()
                   for st in self.inner.state.values() for v in st.values()
                   if isinstance(v, torch.Tensor))

    def named_slices(self):
        """(parameter name, slice, data-axis dim or None) per parameter."""
        return [(name, s, dim) for _, s, dim, name in self.entries]
