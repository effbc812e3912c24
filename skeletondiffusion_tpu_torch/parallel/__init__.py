"""The data axis over ``torch.distributed``: one process a rank, each with
its rows of every batch, gradients and metric values combined across the
ranks (``mesh``); and the multichip dry run (``dryrun``)."""
from .mesh import (
    DataMesh,
    TENSOR_PARALLEL,
    all_gather_host,
    all_reduce_mean,
    coordination_barrier,
    create_mesh,
    maybe_initialize_distributed,
    replicate,
    shard_batch,
)

__all__ = [
    "DataMesh", "TENSOR_PARALLEL", "all_gather_host", "all_reduce_mean",
    "coordination_barrier", "create_mesh", "maybe_initialize_distributed", "replicate",
    "shard_batch",
]
