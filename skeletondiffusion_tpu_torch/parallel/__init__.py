"""The data and model axes over ``torch.distributed``: one process a rank,
each with its rows of every batch, gradients and metric values combined
across the ranks, large weights split over the model axis in training
(``mesh``); and the multichip dry run (``dryrun``)."""
from .mesh import (
    MODEL_AXIS_TRAINING_ONLY,
    DataMesh,
    ModelShard,
    all_gather_host,
    all_reduce_mean,
    clip_grad_norm_,
    coordination_barrier,
    create_mesh,
    maybe_initialize_distributed,
    model_columns,
    model_whole,
    refuse_model_axis,
    replicate,
    shard_batch,
    shard_params_model_axis,
    splits_on_model_axis,
)

__all__ = [
    "DataMesh", "MODEL_AXIS_TRAINING_ONLY", "ModelShard", "all_gather_host", "all_reduce_mean",
    "clip_grad_norm_", "coordination_barrier", "create_mesh", "maybe_initialize_distributed",
    "model_columns", "model_whole", "refuse_model_axis", "replicate", "shard_batch",
    "shard_params_model_axis", "splits_on_model_axis",
]
