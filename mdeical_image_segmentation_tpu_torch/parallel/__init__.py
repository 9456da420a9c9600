"""Data-parallel and spatially sharded training of the port (the JAX
package's ``parallel``): one process per device, global-batch statistics
on the data axis (``mesh``), one volume split over the ranks with halo
exchange (``spatial``).  The tensor-parallel and ZeRO-1 modules wait for
ROADMAP.md queue 1, items 25b.2 and 25b.3."""

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

__all__ = ["DataMesh", "device_prefetch", "distributed", "divides",
           "global_sum", "halo_exchange",
           "local_batch_size", "make_mesh", "make_spatial_train_step",
           "replicate", "rows_split", "shard_batch", "shard_slab",
           "spatial_sharded_apply"]
