"""The optimizer of a training run (counterpart of
``vq_voice_swap_tpu/train/state.py``): AdamW with betas (0.9, 0.999) and
eps 1e-8, which takes the same decoupled weight-decay step as
``optax.adamw``; frozen parameters kept out of it (no moments, no decay,
no update), as optax's ``set_to_zero`` branch keeps them; an optional
linear learning-rate anneal counted as ``optax.linear_schedule`` counts
(the first update uses ``lr``); and an optional clip of the trainable
gradients to a global norm, as ``optax.clip_by_global_norm`` clips them.

On N ranks (``parallel/``) the plain parameters' gradients live in one
flat buffer (``grad_buffer``, a ``parallel.dist.GradBuffer``, which
``zero_grad`` zeroes in place) and, under FSDP, the parameters, gradients
and moments are DTensor shards beside the whole (replicated) ones, which
AdamW then treats as replicated. Under tensor parallelism
(``parallel/tensor.py``) some plain ones are this rank's shards of a
parameter cut over the model group, which AdamW steps as they are. The
clip's norm sums each gradient's squares over the groups that cut it, as
the buffer names them: an FSDP shard's over its data group, a model
shard's over its model group; a gradient whole on the ranks of a group
counts once.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

__all__ = ["Optimizer", "build_optimizer", "global_norm", "prefix_predicate"]


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
        buf = self.grad_buffer
        grads = [p.grad for p in self.params]
        if buf is None:
            norm = global_norm(grads)
        else:
            norm = global_norm(grads, buf.model_cut, buf.data_group, buf.model_group)
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        torch._foreach_mul_([g.to_local() if isinstance(g, DTensor) else g
                             for g in grads if g is not None], scale)

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


def global_norm(grads: Sequence[Optional[torch.Tensor]],
                model_cut: Optional[Sequence[bool]] = None, data_group: Any = None,
                model_group: Any = None) -> torch.Tensor:
    """The global norm of ``grads`` (None: no gradient), each square sum
    summed over the groups that cut its tensor: an FSDP shard (a
    ``DTensor``) over ``data_group``, a shard that ``model_cut`` flags over
    ``model_group``; a tensor whole on every rank counts once. Off the
    ranks, or with no shards, it is the plain norm and runs no
    collective."""
    model_cut = model_cut or [False] * len(grads)
    parts: Dict[Tuple[bool, bool], List[torch.Tensor]] = {}
    for g, cut in zip(grads, model_cut):
        if g is not None:
            fsdp = isinstance(g, DTensor)
            local = g.to_local() if fsdp else g
            parts.setdefault((fsdp, cut), []).append(local.float().square().sum())
    sums = {key: torch.stack(v).sum() for key, v in parts.items()}
    for axis, group in ((0, data_group), (1, model_group)):
        keys = [key for key in sums if key[axis]]
        if keys:
            reduced = torch.stack([sums[key] for key in keys])
            dist.all_reduce(reduced, group=group)
            sums.update(zip(keys, reduced.unbind()))
    return sum(sums.values()).sqrt()


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
