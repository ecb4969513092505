"""The optimizer of a training run (counterpart of
``vq_voice_swap_tpu/train/state.py``): AdamW with betas (0.9, 0.999) and
eps 1e-8, which takes the same decoupled weight-decay step as
``optax.adamw``; frozen parameters kept out of it (no moments, no decay,
no update), as optax's ``set_to_zero`` branch keeps them; an optional
linear learning-rate anneal counted as ``optax.linear_schedule`` counts
(the first update uses ``lr``); and an optional clip of the trainable
gradients to a global norm, as ``optax.clip_by_global_norm`` clips them.

On N ranks (``parallel/``) the whole parameters' gradients live in one
flat buffer (``grad_buffer``, a ``parallel.dist.GradBuffer``, which
``zero_grad`` zeroes in place) and, under FSDP, the parameters, gradients
and moments are DTensor shards beside the whole (replicated) ones: the
clip's norm then sums the shards' squares over the ranks, and AdamW treats
a whole tensor beside shards as replicated.
"""

from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

__all__ = ["Optimizer", "build_optimizer", "prefix_predicate"]


def prefix_predicate(frozen_prefixes: Sequence[str]) -> Callable[[str], bool]:
    """Predicate: is a parameter name ("encoder.blocks.0.conv_in.conv.weight")
    under any of these prefixes ("encoder", "vq")?"""

    def pred(name: str) -> bool:
        return any(name == p or name.startswith(p.rstrip(".") + ".")
                   for p in frozen_prefixes)

    return pred


class Optimizer:
    """AdamW over ``params`` with the anneal and the clip. ``count`` is the
    number of updates taken, which sets the learning rate of the next."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        lr: float,
        weight_decay: float = 0.0,
        lr_final: Optional[float] = None,
        lr_anneal_steps: Optional[int] = None,
        grad_clip: Optional[float] = None,
    ):
        if lr_final is not None and not lr_anneal_steps:
            raise ValueError("need --lr-anneal-steps with --lr-final")
        self.params = list(params)
        self.lr, self.lr_final, self.lr_anneal_steps = lr, lr_final, lr_anneal_steps
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.count = 0
        self.grad_buffer: Optional[Any] = None
        self.sharded = any(isinstance(p, DTensor) for p in self.params)

    def lr_at(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based)."""
        if self.lr_final is None:
            return self.lr
        frac = 1.0 - min(count, self.lr_anneal_steps) / self.lr_anneal_steps
        return (self.lr - self.lr_final) * frac + self.lr_final

    def clip_grads(self) -> None:
        """Scale the gradients by max / norm where their global norm is at
        least max, on the device (no host sync)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not self.sharded:
            norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
        else:
            shards = [g.to_local() for g in grads if isinstance(g, DTensor)]
            whole = [g for g in grads if not isinstance(g, DTensor)]
            squares = torch.stack([g.float().square().sum() for g in shards]).sum()
            dist.all_reduce(squares)
            if whole:
                squares = squares + torch.stack([g.float().square().sum() for g in whole]).sum()
            norm = squares.sqrt()
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        torch._foreach_mul_([g.to_local() if isinstance(g, DTensor) else g for g in grads],
                            scale)

    def step(self) -> None:
        if self.grad_clip:
            self.clip_grads()
        for group in self.adamw.param_groups:
            group["lr"] = self.lr_at(self.count)
        if self.sharded:
            with implicit_replication():  # the whole parameters beside the shards
                self.adamw.step()
        else:
            self.adamw.step()
        self.count += 1

    def zero_grad(self) -> None:
        if self.grad_buffer is None:
            self.adamw.zero_grad(set_to_none=True)
        else:
            self.grad_buffer.zero_grad()

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = state["count"]


def build_optimizer(
    model: nn.Module,
    lr: float,
    weight_decay: float = 0.0,
    frozen_fn: Optional[Callable[[str], bool]] = None,
    lr_final: Optional[float] = None,
    lr_anneal_steps: Optional[int] = None,
    grad_clip: Optional[float] = None,
) -> Optimizer:
    """The optimizer of ``model``'s parameters. Those that ``frozen_fn``
    names stop requiring grad and stay out of it."""
    params = []
    for name, p in model.named_parameters():
        if frozen_fn is not None and frozen_fn(name):
            p.requires_grad_(False)
        else:
            params.append(p)
    return Optimizer(params, lr, weight_decay, lr_final, lr_anneal_steps, grad_clip)
