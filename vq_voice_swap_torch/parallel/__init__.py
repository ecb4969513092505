"""Data-parallel, fully sharded and tensor-parallel training on
``torch.distributed`` (counterpart of the JAX package's ``parallel/``):
``dist`` starts the ranks of a launched run, lays them out as a (data,
model) grid and holds the train step's collectives, ``fsdp`` shards the
model, its EMAs and the optimizer's moments over the data rows,
``tensor`` cuts them over the model columns, and ``sequence`` cuts the
audio's time axis over the ranks."""

from .dist import (GradBuffer, Grid, StepSync, agree, broadcast_from_primary, data_group,
                   data_rank, data_size, gather_data_rows, grid, init_distributed, init_grid,
                   is_primary, launched, local_tensor, rank, rank_device, world_size)
from .fsdp import (fsdp_placements, full_tensor, rebuild_optimizer, shard_like,
                   shard_model_fsdp, shard_optimizer_like, shard_params_like,
                   shard_train_state)
from .sequence import SEQ_AXIS, SeqMesh, create_seq_mesh, sequence_parallel
from .tensor import (MODEL_AXIS, cut_axes, full_tensor_tp, global_tensor, shard_like_tp,
                     shard_model_tp, tp_placements)

__all__ = [
    "GradBuffer",
    "Grid",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "SeqMesh",
    "StepSync",
    "agree",
    "broadcast_from_primary",
    "create_seq_mesh",
    "cut_axes",
    "data_group",
    "data_rank",
    "data_size",
    "fsdp_placements",
    "full_tensor",
    "full_tensor_tp",
    "gather_data_rows",
    "global_tensor",
    "grid",
    "init_distributed",
    "init_grid",
    "is_primary",
    "launched",
    "local_tensor",
    "rank",
    "rank_device",
    "rebuild_optimizer",
    "shard_like",
    "shard_like_tp",
    "shard_model_fsdp",
    "shard_model_tp",
    "shard_optimizer_like",
    "shard_params_like",
    "sequence_parallel",
    "shard_train_state",
    "tp_placements",
    "world_size",
]
