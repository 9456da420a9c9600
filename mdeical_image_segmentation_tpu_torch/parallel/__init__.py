"""Distributed training of the port (the JAX package's ``parallel``): one
process per device on a (data, model) mesh, global-batch statistics on the
data axis (``mesh``), one volume split over the ranks with halo exchange
(``spatial``), conv out-channels sharded over the model axis (``tensor``)
and the optimizer state over the data axis (``zero``)."""

from . import distributed
from .mesh import (
    DataMesh,
    device_prefetch,
    divides,
    global_sum,
    local_batch_size,
    make_mesh,
    replicate,
    rows_split,
    shard_batch,
)
from .spatial import (
    halo_exchange,
    make_spatial_train_step,
    shard_slab,
    spatial_sharded_apply,
)
from .tensor import (
    copy_to_model,
    gather_from_model,
    shard_params_tp,
    tp_param_specs,
)
from .zero import Zero1Optimizer, zero1_specs

__all__ = ["DataMesh", "Zero1Optimizer", "copy_to_model", "device_prefetch",
           "distributed", "divides", "gather_from_model", "global_sum",
           "halo_exchange", "local_batch_size", "make_mesh",
           "make_spatial_train_step", "replicate", "rows_split",
           "shard_batch", "shard_params_tp", "shard_slab",
           "spatial_sharded_apply", "tp_param_specs", "zero1_specs"]
