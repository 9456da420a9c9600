"""Channel tensor parallelism over the mesh's ``model`` axis (the JAX
package's ``parallel/tensor.py``).

The JAX package shards every parameter's output-channel dim over ``model``
(``tp_param_specs``: a kernel's trailing dim, and a 1-D vector, when it
divides) and lets GSPMD place the collectives.  The port has no GSPMD, so
it places them by hand, column-parallel:

- ``shard_params_tp(model, mesh)`` slices each such parameter in place to
  this rank's contiguous block (``tp_param_specs`` gives the dims, in the
  port's layout: out-channels are dim 0 of a conv's (O, I, *k) and a
  Dense's (out, in) weight, dim 1 of a transposed conv's (I, O, *k)) and
  marks the module (``tp_dims``, ``tp_mesh``);
- a sharded conv or Dense computes ``gather(f(copy(x_full), W_shard) +
  b_shard)`` (``column_parallel``): ``copy_to_model`` is the identity
  forward and all-reduces the partial input gradient backward,
  ``gather_from_model`` all-gathers the channel blocks forward and hands
  each rank its block of the gradient backward;
- everything between two such layers runs replicated and identical on the
  model ranks (pools, upsampling, concats, GroupNorm and BatchNorm of the
  full tensor, a head that does not divide, the loss); a sharded 1-D norm
  parameter enters through ``gather_from_model`` (``full_param``), and
  through ``copy_to_model`` too where a sharded conv's prologue reads it.

So the math is the replicated model's: one all-gather forward and one
all-reduce backward per sharded layer, over the model group.  Under gloo
(ranks sharing one card) a CUDA block is gathered through the host
(``mesh.all_gather_dim``); gloo all-reduces CUDA tensors itself.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import MODEL_AXIS, DataMesh, all_gather_dim

Spec = Tuple[Optional[str], ...]


def leaf_dim(shape, out_dim: int, n: int) -> Optional[int]:
    """The JAX package's ``_leaf_spec`` on the port's layout: a tensor of
    2 or more dims is sharded on its out-channel dim ``out_dim`` when that
    divides by ``n``, a vector when its length divides (and is at least
    ``n``); else None (replicated)."""
    shape = tuple(shape)
    if len(shape) >= 2 and shape[out_dim] % n == 0:
        return out_dim
    if len(shape) == 1 and shape[0] % n == 0 and shape[0] >= n:
        return 0
    return None


def _layers():
    # models import parallel: import late
    from ..models.layers2d import TorchBatchNorm, TorchConv, TorchConvTranspose
    from ..models.se3d import Dense
    from ..ops.norm import GroupNorm

    return TorchConv, TorchConvTranspose, Dense, GroupNorm, TorchBatchNorm


def _out_dim(module: nn.Module) -> int:
    """The out-channel dim of ``module``'s weight in the port's layout."""
    _, transposed, *_ = _layers()
    return 1 if isinstance(module, transposed) else 0


def _module_dims(module: nn.Module, n: int) -> Dict[str, Optional[int]]:
    """{parameter name: sharded dim or None} of ``module``'s own
    parameters; raises for a module without a tensor-parallel form."""
    own = dict(module.named_parameters(recurse=False))
    if own and not isinstance(module, _layers()):
        raise NotImplementedError(
            f"{type(module).__name__} holds parameters and has no "
            "tensor-parallel form (convs, Dense, GroupNorm, BatchNorm)")
    out = _out_dim(module)
    return {k: leaf_dim(p.shape, out, n) for k, p in own.items()}


def tp_param_specs(model: nn.Module, n: int) -> Dict[str, Spec]:
    """{parameter name: spec} over ``n`` model ranks, a spec a tuple of one
    entry per dim, ``"model"`` on the sharded one (the JAX package's
    PartitionSpec in the port's layout; ``utils/param_bridge.flax_dim``
    maps a dim to the flax tree's)."""
    specs = {}
    for prefix, module in model.named_modules():
        for k, d in _module_dims(module, n).items():
            p = getattr(module, k)
            specs[f"{prefix}.{k}" if prefix else k] = tuple(
                MODEL_AXIS if i == d else None for i in range(p.ndim))
    return specs


def shard_params_tp(model: nn.Module, mesh: DataMesh,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> nn.Module:
    """Slice every parameter that ``tp_param_specs`` shards to this rank's
    contiguous block of its out-channels, in place (the ``Parameter``
    objects stay, so an optimizer built on them keeps them; its state of
    a parameter's shape is sliced alike), and mark the modules.  A model
    axis of 1 changes nothing."""
    n, r = mesh.model_size, mesh.model_rank
    if n == 1:
        return model
    for module in model.modules():
        dims = {k: d for k, d in _module_dims(module, n).items()
                if d is not None}
        if not dims:
            continue
        for k, d in dims.items():
            p = getattr(module, k)
            full = tuple(p.shape)
            block = full[d] // n
            with torch.no_grad():
                p.data = p.data.narrow(d, r * block, block).clone()
            state = optimizer.state.get(p, {}) if optimizer else {}
            for key, v in state.items():
                if isinstance(v, torch.Tensor) and tuple(v.shape) == full:
                    state[key] = v.narrow(d, r * block, block).clone()
        module.tp_dims = dims
        module.tp_mesh = mesh
    return model


def is_sharded(module: nn.Module) -> bool:
    return bool(getattr(module, "tp_dims", None))


def sharded_dims(model: nn.Module) -> Dict[str, int]:
    """{parameter name: its model-axis dim} of the sharded parameters."""
    return {(f"{prefix}.{k}" if prefix else k): d
            for prefix, module in model.named_modules()
            for k, d in (getattr(module, "tp_dims", None) or {}).items()}


def model_mesh(model: nn.Module) -> Optional[DataMesh]:
    """The mesh a sharded ``model`` was sharded over, or None."""
    for module in model.modules():
        if is_sharded(module):
            return module.tp_mesh
    return None


# -- the collectives ----------------------------------------------------------


def _all_reduce_model(g: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``g`` summed over the model group (in float32 for a 16-bit dtype:
    two partials rounded once, as one add in that dtype rounds them)."""
    out = g.to(torch.float32 if g.dtype in (torch.bfloat16, torch.float16)
               else g.dtype, copy=True).contiguous()
    dist.all_reduce(out, group=mesh.model_group)
    return out.to(g.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_model(g, ctx.mesh), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim % x.ndim, mesh
        return all_gather_dim(x, ctx.dim, mesh.model_group, mesh.model_size)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.mesh, ctx.dim
        block = g.shape[dim] // mesh.model_size
        return (g.narrow(dim, mesh.model_rank * block, block).contiguous(),
                None, None)


def copy_to_model(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model axis."""
    return _CopyToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int, mesh: DataMesh
                      ) -> torch.Tensor:
    """The model ranks' blocks of ``x`` concatenated along ``dim``; the
    gradient's block of this rank backward."""
    return _GatherFromModel.apply(x, dim, mesh)


def full_param(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """``module.<name>``, gathered over the model axis when it is sharded
    (differentiably)."""
    p = getattr(module, name)
    dims = getattr(module, "tp_dims", None)
    if p is None or not dims or name not in dims:
        return p
    return gather_from_model(p, dims[name], module.tp_mesh)


def column_parallel(module: nn.Module, fn: Callable[..., torch.Tensor],
                    x: torch.Tensor, *extra: torch.Tensor) -> torch.Tensor:
    """``fn(x, *extra)`` of an out-channel-sharded ``module`` (a
    channels-last output, its block of the channels):
    ``gather(fn(copy(x), *copy(extra)))`` over the model axis; ``fn(x,
    *extra)`` when ``module`` is not sharded."""
    if not is_sharded(module):
        return fn(x, *extra)
    mesh = module.tp_mesh
    y = fn(copy_to_model(x, mesh), *(copy_to_model(t, mesh) for t in extra))
    return gather_from_model(y, -1, mesh)


@contextlib.contextmanager
def full_parameters(model: nn.Module) -> Iterator[nn.Module]:
    """Within: every sharded parameter of ``model`` holds its whole tensor
    (gathered over the model axis), for a writer of whole weights; the
    shards come back after.  Every rank of the model axis enters it."""
    swapped = []
    with torch.no_grad():
        for module in model.modules():
            for k, d in (getattr(module, "tp_dims", None) or {}).items():
                p = getattr(module, k)
                mesh = module.tp_mesh
                swapped.append((p, p.data))
                p.data = all_gather_dim(p.data, d, mesh.model_group,
                                        mesh.model_size)
    try:
        yield model
    finally:
        for p, shard in swapped:
            p.data = shard


def grad_norm_squared(params, model: nn.Module) -> torch.Tensor:
    """The squared global norm of ``params``' gradients (the replicated
    model's): the sharded ones' squares summed over the model axis, the
    replicated ones' counted once."""
    sharded = {id(p) for module in model.modules()
               for k in (getattr(module, "tp_dims", None) or {})
               for p in (getattr(module, k),)}
    grads = [p.grad for p in params]
    norms = torch.stack(torch._foreach_norm(grads)).square()
    mask = torch.tensor([id(p) in sharded for p in params],
                        device=norms.device)
    part = norms[mask].sum()
    mesh = model_mesh(model)
    if mesh is not None:
        part = _all_reduce_model(part, mesh)
    return part + norms[~mask].sum()
