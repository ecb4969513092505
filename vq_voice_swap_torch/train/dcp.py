"""The sharded run-directory format, ``--checkpoint-format dcp``
(counterpart of the JAX package's Orbax format): every rank writes its own
shards with ``torch.distributed.checkpoint``, with no gather.

``model.dcp/`` holds the model's parameters and buffers (``model.<name>``)
and ``model.json``, the class and constructor kwargs that an npz
checkpoint carries; each EMA is a model directory of its own,
``model_ema_<rate>.dcp/`` (its parameters and the model's buffers, as the
npz EMA files and the JAX package's Orbax ones are), so ``ModelBase.load``
and every CLI read the model and a named EMA alike
(``checkpoint.load_dcp_checkpoint``). ``opt.dcp/`` holds AdamW's state of
each trainable parameter (``<name>.step``, ``<name>.exp_avg``,
``<name>.exp_avg_sq``) and the update count (``count``).

A save writes every ``<dir>.new`` and then commits each as the JAX
package's ``_commit_staged`` does: the old directory is renamed to
``<dir>.old``, ``<dir>.new`` renamed into place, ``<dir>.old`` removed. A
crash between the two renames leaves ``<dir>`` missing and ``<dir>.new``
complete, and every load here (and the loops' checks, ``exists``) falls
back to it (``staged_fallback``). The EMAs of runs saved before they had
directories of their own (``ema_<rate>.<name>`` inside ``model.dcp``) are
still read on resume. A load reads into whole tensors, so a run resumes
at any world size, with or without FSDP or tensor parallelism (the loop
shards after loading). Under tensor parallelism a rank's shards of a leaf cut
over its model group are written as ``DTensor``s of the whole leaf on the
(data, model) mesh (``parallel.tensor.global_tensor``), so each lands at
its global offsets.
"""

import json
import os
import shutil
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ..checkpoint import DCP_MANIFEST, staged_fallback
from ..model_base import ModelBase
from ..parallel.dist import is_primary
from ..parallel.tensor import global_tensor
from .ema import EMA
from .state import Optimizer

__all__ = ["exists", "load_emas", "load_optimizer", "save_run"]


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _keys(path: str) -> set:
    return set(dcp.FileSystemReader(path).read_metadata().state_dict_metadata)


def exists(path: str) -> bool:
    """Whether a checkpoint directory can be loaded: ``path``, or its
    complete ``.new`` staging directory (``staged_fallback``)."""
    return os.path.exists(staged_fallback(path))


def _commit_staged(path: str) -> None:
    """Swap ``path.new`` over ``path`` (the JAX package's _commit_staged):
    before the first rename the old directory is intact; between the
    renames ``path`` is missing and ``path.new`` complete (loaders fall
    back to it); after them the new directory is live."""
    old = path + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(path + ".new", path)
    shutil.rmtree(old, ignore_errors=True)


def save_run(model_dir: str, ema_dirs: Sequence[str], opt_dir: str, model: ModelBase,
             emas: Sequence[EMA], optimizer: Optimizer, names: Sequence[str],
             tp_axes: Optional[Dict[str, int]] = None) -> None:
    """Write the model, each EMA (into ``ema_dirs``, in ``emas``' order) and
    the optimizer state (``names``: the optimizer's parameters' names, in
    its order; ``tp_axes``: {parameter name: axis} of those cut over the
    model group); every rank calls it."""
    tp_axes = tp_axes or {}

    def placed(name: str, t: torch.Tensor) -> torch.Tensor:
        return global_tensor(t, tp_axes[name]) if name in tp_axes and t.ndim else t

    model_state: Dict[str, torch.Tensor] = {
        f"model.{k}": placed(k, v) for k, v in model.state_dict().items()}
    buffers = {f"model.{n}": b for n, b in model.named_buffers()}
    states = [(model_dir, model_state)]
    for path, ema in zip(ema_dirs, emas):
        state = {f"model.{n}": placed(n, p) for n, p in ema.model.named_parameters()}
        state.update(buffers)
        states.append((path, state))
    opt_state: Dict[str, torch.Tensor] = {"count": torch.tensor(optimizer.count)}
    for n, p in zip(names, optimizer.params):
        opt_state.update((f"{n}.{k}", placed(n, v))
                         for k, v in optimizer.adamw.state.get(p, {}).items())
    states.append((opt_dir, opt_state))
    for path, state in states:
        if is_primary() and os.path.exists(path + ".new"):
            shutil.rmtree(path + ".new")
        _barrier()
        dcp.save(state, checkpoint_id=path + ".new")
    _barrier()
    if is_primary():
        manifest = {"class": model.class_name(), "kwargs": model.save_kwargs()}
        for path in (model_dir, *ema_dirs):
            with open(os.path.join(path + ".new", DCP_MANIFEST), "w") as f:
                json.dump(manifest, f)
        for path, _ in states:
            _commit_staged(path)
    _barrier()


def load_emas(model_path: str, ema_paths: Sequence[str], emas: Sequence[EMA]) -> List[float]:
    """Load each EMA from its own directory (``ema_paths``, in ``emas``'
    order), or, for a run saved before EMAs had directories of their own,
    from ``model.dcp``'s ``ema_<rate>.*`` entries; returns the rates
    loaded."""
    legacy = _keys(staged_fallback(model_path)) if exists(model_path) else set()
    loaded = []
    for path, ema in zip(ema_paths, emas):
        params = dict(ema.model.named_parameters())
        if exists(path):
            source, prefix = staged_fallback(path), "model."
        elif all(f"ema_{ema.rate}.{n}" in legacy for n in params):
            source, prefix = staged_fallback(model_path), f"ema_{ema.rate}."
        else:
            continue
        dcp.load({prefix + n: p.detach() for n, p in params.items()}, checkpoint_id=source)
        loaded.append(ema.rate)
    return loaded


def load_optimizer(path: str, optimizer: Optimizer, names: Sequence[str]) -> None:
    """Load ``opt.dcp`` into ``optimizer`` (whole tensors on its
    parameters' devices; the step counts on the CPU, as AdamW keeps them)."""
    path = staged_fallback(path)
    keys = _keys(path)
    state: Dict[str, torch.Tensor] = {"count": torch.zeros((), dtype=torch.int64)}
    for n, p in zip(names, optimizer.params):
        if f"{n}.exp_avg" not in keys:
            continue
        st = {"step": torch.zeros((), dtype=torch.float32),
              "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
        optimizer.adamw.state[p] = st
        state.update((f"{n}.{k}", v) for k, v in st.items())
    dcp.load(state, checkpoint_id=path)
    optimizer.count = int(state["count"])
