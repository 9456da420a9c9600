"""Data-parallel training of the port (the JAX package's ``parallel``, its
data axis): one process per device under DDP, global-batch statistics.
The spatial, tensor-parallel and ZeRO-1 modules wait for ROADMAP.md queue
1, item 25b."""

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

__all__ = ["DataMesh", "device_prefetch", "distributed", "divides",
           "global_sum", "local_batch_size", "make_mesh", "replicate",
           "rows_split", "shard_batch"]
