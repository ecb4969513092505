"""Tensor (model) parallelism over the ranks' (data, model) grid
(counterpart of the JAX package's ``parallel/tensor.py``; the grid is
``dist.init_grid``).

The placement is the JAX package's ``model_axis_shards_last_dim``: a
parameter is cut over the T ranks of its model group along its JAX layout's
last axis (output features) when it has one, T divides it and the name is
not the VQ dictionary's (whole code vectors stay together). In the port's
layout that axis is a conv or dense weight's axis 0, an embedding table's
axis 1 (flax ``Embed`` is not transposed) and a bias's or a norm scale's
axis 0 (``_jax_axes``). ``shard_model_tp`` keeps this rank's slice of each
such parameter, contiguous, and records its axis on the module
(``TP_AXES``); parameters, EMA copies and AdamW moments are stored so,
buffers and the step count whole.

The compute is exact against one device whatever a leaf's output
features mean (a FiLM projection's scale and shift halves, for one):

- every cut ``Conv1d`` and ``Linear`` runs column-parallel, through the
  funnels ``models.layers.conv1d`` and ``linear``: the rank computes its
  own output channels from the whole input, all-gathers them along the
  channel axis within its model group (backward: its slice of the
  gradient), and the input's gradient is summed over the model group
  (Megatron's f and g, ``_ToModel`` and ``_GatherModel``);
- every other op runs on whole, replicated activations as on one device,
  and the small cut leaves it reads (GroupNorm and LayerNorm affines, the
  label tables' columns) are gathered whole at use (``whole``);
- the fused ResBlock pair takes whole weights: ``gathered`` lends a
  block its whole leaves for one call, so the pair runs whole on every
  rank (storage sharding for those blocks, not split work).

Gathers are plain ``dist.all_gather`` calls on tensors: DTensor's
functional collectives crash gloo with CUDA tensors (torch 2.11), and two
ranks that share one card must run gloo. Every rank of a model group
computes the same whole activations, so a parameter kept whole gets the
same gradient on each up to the order of a backward's atomic sums; like a
cut one it is summed over the data group only, and then the model group
takes its model rank 0's gradient, so its copies never drift apart
(``dist.GradBuffer``, ``dist.StepSync``).
"""

import contextlib
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from .dist import grid

__all__ = ["MODEL_AXIS", "TP_AXES", "column_parallel", "cut_axes", "cut_axis", "full_tensor_tp",
           "gathered", "global_tensor", "shard_like_tp", "shard_model_tp", "tp_placements",
           "whole"]

MODEL_AXIS = "model"

# The module attribute {leaf: port axis} of the leaves that shard_model_tp cut.
TP_AXES = "_tp_axes"


def _jax_axes(module: nn.Module, leaf: str, ndim: int) -> List[int]:
    """The port's axes of a parameter in the JAX layout's order."""
    axes = list(range(ndim))
    if leaf == "weight" and isinstance(module, (nn.Conv1d, nn.Linear)):
        axes.reverse()  # flax kernels: (K, C_in, C_out) and (in, out)
    return axes


def tp_placements(model: nn.Module, tensor_parallel: int) -> Dict[str, Optional[int]]:
    """{parameter name: the port axis it is cut along over the model
    group, or None (kept whole)} at model size ``tensor_parallel``, by the
    JAX package's rule."""
    out = {}
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            axis = None
            if tensor_parallel > 1 and p.ndim > 0 and "dictionary" not in name:
                last = _jax_axes(module, leaf, p.ndim)[-1]
                if p.shape[last] % tensor_parallel == 0:
                    axis = last
            out[name] = axis
    return out


def _group():
    g = grid()
    if g is None:
        raise RuntimeError("tensor parallelism needs the ranks' grid (dist.init_grid)")
    return g


@torch.no_grad()
def shard_model_tp(model: nn.Module,
                   placements: Optional[Dict[str, Optional[int]]] = None) -> Dict[str, int]:
    """Cut ``model``'s parameters (whole, on this rank's device) to this
    rank's shards in place, by ``placements`` (default: ``tp_placements``
    at the grid's model size); returns {name: axis} of the cut ones."""
    g = _group()
    if placements is None:
        placements = tp_placements(model, g.model_size)
    cut = {}
    for mod_name, module in model.named_modules():
        for leaf, p in list(module.named_parameters(recurse=False)):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            axis = placements[name]
            if axis is None:
                continue
            shard = shard_like_tp(p.detach(), axis)
            module.register_parameter(leaf, nn.Parameter(shard, requires_grad=p.requires_grad))
            module.__dict__.setdefault(TP_AXES, {})[leaf] = axis
            cut[name] = axis
    return cut


def shard_like_tp(full: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """This rank's contiguous slice of ``full`` along ``axis`` over its
    model group (``full`` itself for None)."""
    if axis is None:
        return full
    g = _group()
    return full.chunk(g.model_size, dim=axis)[g.model_rank].contiguous()


def _all_gather(local: torch.Tensor, dim: int) -> torch.Tensor:
    g = _group()
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(g.model_size)]
    dist.all_gather(parts, local, group=g.model_group)
    return torch.cat(parts, dim=dim)


def full_tensor_tp(t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """A shard cut along ``axis`` (None: a whole tensor) gathered whole
    over the model group, detached; an FSDP ``DTensor`` is gathered over
    the data group first (collectives: every rank calls it, in order)."""
    from .fsdp import full_tensor

    t = full_tensor(t).detach()
    return t if axis is None else _all_gather(t, axis)


def global_tensor(t: torch.Tensor, axis: int) -> DTensor:
    """This rank's shard of a leaf cut along ``axis`` (a plain tensor, or
    an FSDP ``DTensor`` over the data group) as a ``DTensor`` of the whole
    leaf on the grid's (data, model) mesh, sharing its memory: what a
    ``torch.distributed.checkpoint`` save writes with its global shape and
    offsets."""
    g = _group()
    if isinstance(t, DTensor):
        local, (data,) = t.to_local(), t.placements
    else:
        local, data = t, Replicate()
    shape = list(t.shape)
    shape[axis] *= g.model_size
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, g.mesh, [data, Shard(axis)], run_check=False,
                              shape=torch.Size(shape), stride=stride)


def cut_axis(module: nn.Module, leaf: str) -> Optional[int]:
    """The axis ``module``'s ``leaf`` was cut along, or None."""
    return module.__dict__.get(TP_AXES, {}).get(leaf)


def cut_axes(model: nn.Module) -> Dict[str, int]:
    """{parameter name: axis} of ``model``'s parameters cut over the model
    group (empty off the grid)."""
    return {f"{mod_name}.{leaf}" if mod_name else leaf: axis
            for mod_name, module in model.named_modules()
            for leaf, axis in module.__dict__.get(TP_AXES, {}).items()}


class _ToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=_group().model_group)
        return grad


class _GatherModel(torch.autograd.Function):
    """The model group's shards concatenated along ``dim``; the backward
    takes this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, local, dim):
        ctx.dim = dim
        return _all_gather(local, dim)

    @staticmethod
    def backward(ctx, grad):
        g = _group()
        return grad.chunk(g.model_size, dim=ctx.dim)[g.model_rank].contiguous(), None


def column_parallel(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn`` (this rank's output channels of a cut layer, from the whole
    input) on the whole ``x``, gathered along ``dim`` over the model group."""
    return _GatherModel.apply(fn(_ToModel.apply(x)), dim)


def whole(module: nn.Module, leaf: str) -> torch.Tensor:
    """``module``'s parameter ``leaf`` whole: gathered over the model group
    (differentiably) when it was cut, else as it is."""
    p = getattr(module, leaf)
    axis = cut_axis(module, leaf)
    return p if axis is None else _GatherModel.apply(p, axis)


@contextlib.contextmanager
def gathered(module: nn.Module) -> Iterator[None]:
    """Lend every cut leaf under ``module`` its whole tensor (gathered,
    without grad) for the body, then restore the shards."""
    lent = []
    with torch.no_grad():
        for m in module.modules():
            for leaf, axis in m.__dict__.get(TP_AXES, {}).items():
                lent.append((m, leaf, m._parameters[leaf]))
                m._parameters[leaf] = _all_gather(m._parameters[leaf], axis)
    try:
        yield
    finally:
        for m, leaf, p in lent:
            m._parameters[leaf] = p
