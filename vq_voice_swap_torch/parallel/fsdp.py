"""Fully sharded data parallelism (counterpart of the JAX package's
``parallel/fsdp.py``) on FSDP2's ``fully_shard``: parameters, EMA shadows
and AdamW moments are stored sharded over the ranks, each parameter along
the axis that the JAX package's ``fsdp_shardings`` picks, its largest axis
that the world size divides (the first of equal ones, in the JAX layout:
a conv or dense kernel's axes are the port's weight's in reverse). The VQ
dictionary stays whole, as does a parameter with no such axis; those are
FSDP2's ``ignored_params``, replicated, and their gradients are all-reduced
by hand (``dist.GradBuffer``).

``shard_model_fsdp`` applies ``fully_shard`` to every entry of the model's
``nn.ModuleList``s (the UNet's and encoder's blocks), then to the root,
whose ``losses`` runs under FSDP2's hooks as ``forward`` does. Gradients
are summed, not averaged: each rank weights its loss by its share of the
global batch. Outside a forward a sharded parameter is a ``DTensor``;
``full_tensor`` gathers it (a collective) and ``shard_like`` cuts a full
tensor to this rank's shard of one; ``shard_params_like`` and
``shard_optimizer_like`` place an EMA's copy and the optimizer's moments
as the model's parameters are placed.

With tensor parallelism (``parallel/tensor.py``) the placement is the JAX
package's on a (data, model) mesh: the model axis takes a leaf's output
features first (``tp_placements``), FSDP then the largest of its other
axes that the data size divides; ``fully_shard`` runs over the data
group's mesh on the model shards.
"""

from typing import Any, Callable, Dict, Optional, Sequence, Set

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard, init_device_mesh

from .dist import data_size, grid
from .tensor import _jax_axes, shard_like_tp, shard_model_tp, tp_placements

__all__ = ["fsdp_placements", "full_tensor", "rebuild_optimizer", "shard_like",
           "shard_model_fsdp", "shard_optimizer_like", "shard_params_like",
           "shard_train_state"]


def fsdp_placements(model: nn.Module, world: int,
                    tensor_parallel: int = 1) -> Dict[str, Optional[int]]:
    """{parameter name: the axis it is sharded along, or None (kept
    whole)} at data size ``world``, by the JAX package's rule; with a
    model size ``tensor_parallel`` > 1, among the axes that the model axis
    leaves (``model`` is whole here)."""
    model_axes = tp_placements(model, tensor_parallel)
    out = {}
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            axis = None
            if "dictionary" not in leaf:
                candidates = [a for a in _jax_axes(module, leaf, p.ndim)
                              if a != model_axes[name] and p.shape[a] % world == 0]
                if candidates:
                    axis = max(candidates, key=lambda a: p.shape[a])
            out[name] = axis
    return out


def _blocks(model: nn.Module):
    """The entries of the model's outermost ModuleLists, in module order."""
    blocks = []
    for _, module in model.named_modules():
        if isinstance(module, nn.ModuleList) and not any(
                module is b or any(module is m for m in b.modules()) for b in blocks):
            blocks.extend(module)
    return blocks


def shard_model_fsdp(model: nn.Module, world: int,
                     placements: Optional[Dict[str, Optional[int]]] = None,
                     mesh: Optional[DeviceMesh] = None) -> Set[nn.Parameter]:
    """Shard ``model`` (on this rank's device) over ``mesh``'s ``world``
    ranks in place, by ``placements`` (default: the default process group
    and ``fsdp_placements`` at ``world``); returns the parameters kept
    whole."""
    if placements is None:
        placements = fsdp_placements(model, world)
    params = dict(model.named_parameters())
    axis_of = {p: placements[n] for n, p in params.items()}
    ignored = {p for p, a in axis_of.items() if a is None}
    device = next(iter(params.values())).device
    if mesh is None:
        mesh = init_device_mesh(device.type, (world,))
    units = _blocks(model) + [model]
    for unit in units:
        fully_shard(unit, mesh=mesh, shard_placement_fn=lambda p: Shard(axis_of[p]),
                    ignored_params=ignored)
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)
    if hasattr(model, "losses"):
        register_fsdp_forward_method(model, "losses")
    return ignored


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective: every rank calls it, in the
    same order), else ``t``. The shards are even (``fsdp_placements``
    picks only axes the world size divides), so a plain ``all_gather``
    does: DTensor's own ``full_tensor`` goes through the functional
    collectives, which crash gloo with CUDA tensors (torch 2.11)."""
    if not isinstance(t, DTensor):
        return t
    (placement,) = t.placements
    local = t.to_local().detach().contiguous()
    parts = [torch.empty_like(local) for _ in range(t.device_mesh.size())]
    dist.all_gather(parts, local, group=t.device_mesh.get_group())
    return torch.cat(parts, dim=placement.dim)


def shard_like(full: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``full`` (``ref``'s global shape) as ``ref``'s placement: this
    rank's shard of it as a DTensor when ``ref`` is one, else ``full``."""
    if not isinstance(ref, DTensor):
        return full
    (placement,) = ref.placements
    mesh = ref.device_mesh
    local = full.to(ref.device).chunk(mesh.size(), dim=placement.dim)[mesh.get_local_rank()]
    return DTensor.from_local(local.contiguous(), mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


@torch.no_grad()
def shard_params_like(copy: nn.Module, model: nn.Module) -> None:
    """Replace the parameters of ``copy`` (an unsharded copy of ``model``,
    such as an EMA's) with shards placed as ``model``'s are."""
    for mod_name, module in copy.named_modules():
        for leaf, p in list(module.named_parameters(recurse=False)):
            ref = model.get_parameter(f"{mod_name}.{leaf}" if mod_name else leaf)
            if isinstance(ref, DTensor):
                module.register_parameter(
                    leaf, nn.Parameter(shard_like(p.detach(), ref), requires_grad=p.requires_grad))


@torch.no_grad()
def rebuild_optimizer(opt: Any, params: Sequence[torch.Tensor],
                      cut: Callable[[torch.Tensor, int], torch.Tensor]) -> Any:
    """``opt`` (a ``train.state.Optimizer``) over ``params``, its own
    parameters in order as a sharded model now holds them: the same
    settings, count and moments, each moment of parameter i through
    ``cut(moment, i)``."""
    new = type(opt)(params, opt.lr, opt.weight_decay, opt.lr_final, opt.lr_anneal_steps,
                    opt.grad_clip)
    new.count = opt.count
    for i, (old, p) in enumerate(zip(opt.params, new.params)):
        state = opt.adamw.state.get(old)
        if state:
            new.adamw.state[p] = {k: cut(v, i) if v.ndim else v for k, v in state.items()}
    return new


def shard_optimizer_like(opt: Any, params: Sequence[torch.Tensor]) -> Any:
    """``opt`` over FSDP's ``params``, each moment cut to its parameter's
    shard (``rebuild_optimizer``)."""
    return rebuild_optimizer(opt, params, lambda v, i: shard_like(v, params[i]))


def shard_train_state(model: nn.Module, emas: Sequence[Any], opt: Any, names: Sequence[str],
                      fsdp: bool) -> Any:
    """Place a run's whole state (``model``, its ``emas`` and ``opt``, a
    ``train.state.Optimizer`` whose parameters are ``model``'s ``names``)
    on this rank: on the grid (``dist.init_grid``), cut over the model
    group (``parallel/tensor.py``; ``tensor.cut_axes`` reads the cut back);
    with ``fsdp``, then sharded over the data group. Returns the optimizer
    over the placed parameters."""
    g = grid()
    model_size = 1 if g is None else g.model_size
    data_axes = fsdp_placements(model, data_size(), model_size) if fsdp else None
    if g is not None:
        placements = tp_placements(model, model_size)
        cut = shard_model_tp(model, placements)
        for ema in emas:
            shard_model_tp(ema.model, placements)
        axes = [cut.get(n) for n in names]
        opt = rebuild_optimizer(opt, [model.get_parameter(n) for n in names],
                                lambda v, i: shard_like_tp(v, axes[i]))
    if fsdp:
        shard_model_fsdp(model, data_size(), data_axes, None if g is None else g.mesh["data"])
        for ema in emas:
            shard_params_like(ema.model, model)
        opt = shard_optimizer_like(opt, [model.get_parameter(n) for n in names])
    return opt
