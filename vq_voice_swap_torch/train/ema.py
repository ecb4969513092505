"""Exponential moving averages of a model's parameters (counterpart of
``vq_voice_swap_tpu/train/ema.py``), one copy of the model per rate:
``ema += (1 - rate) * (p - ema)`` after every step, with 1 - rate taken in
float32 as the JAX package takes it. Under FSDP or tensor parallelism the
copy's parameters are shards placed as the model's
(``parallel.fsdp.shard_train_state``), and each shard follows its own."""

import copy

import numpy as np
import torch
from torch import nn

from ..parallel.dist import local_tensor

__all__ = ["EMA"]


class EMA:
    """A frozen copy of ``model`` whose parameters follow it at ``rate``."""

    def __init__(self, model: nn.Module, rate: float):
        self.rate = rate
        self.weight = float(np.float32(1.0) - np.float32(rate))
        self.model = copy.deepcopy(model).requires_grad_(False)

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        torch._foreach_lerp_([local_tensor(p) for p in self.model.parameters()],
                             [local_tensor(p) for p in model.parameters()], self.weight)
