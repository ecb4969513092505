"""Data-parallel and fully sharded training on ``torch.distributed``
(counterpart of the JAX package's ``parallel/``): ``dist`` starts the
ranks of a launched run and holds the train step's collectives, ``fsdp``
shards the model, its EMAs and the optimizer's moments."""

from .dist import (GradBuffer, StepSync, agree, broadcast_from_primary, init_distributed,
                   is_primary, launched, local_tensor, rank, rank_device, world_size)
from .fsdp import (fsdp_placements, full_tensor, shard_like, shard_model_fsdp,
                   shard_optimizer_like, shard_params_like)

__all__ = [
    "GradBuffer",
    "StepSync",
    "agree",
    "broadcast_from_primary",
    "fsdp_placements",
    "full_tensor",
    "init_distributed",
    "is_primary",
    "launched",
    "local_tensor",
    "rank",
    "rank_device",
    "shard_like",
    "shard_model_fsdp",
    "shard_optimizer_like",
    "shard_params_like",
    "world_size",
]
