"""Data parallelism over ``torch.distributed``. Port of ``kbe_tpu/parallel``:
a 1-D data mesh of ranks, one process a device, batch-split inference (the
64-image -> 64-video layout) and data-parallel training whose step is the
joint batch's step."""

from kbe_torch.parallel.mesh import (
    DATA_AXIS,
    DataMesh,
    data_mesh,
    host_local_batch_to_global,
    initialize_multihost,
    process_shard_indices,
    replicate,
    shard_batch,
)
from kbe_torch.parallel.dp import (
    batch_parallel_effect,
    data_parallel_step,
    global_mean,
    global_sum,
    mean_over_ranks,
)

__all__ = [
    "DATA_AXIS",
    "DataMesh",
    "data_mesh",
    "host_local_batch_to_global",
    "initialize_multihost",
    "process_shard_indices",
    "replicate",
    "shard_batch",
    "batch_parallel_effect",
    "data_parallel_step",
    "global_mean",
    "global_sum",
    "mean_over_ranks",
]
