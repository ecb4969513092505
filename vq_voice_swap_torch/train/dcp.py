"""The sharded run-directory format, ``--checkpoint-format dcp``
(counterpart of the JAX package's Orbax format): every rank writes its own
shards with ``torch.distributed.checkpoint``, with no gather.

``model.dcp/`` holds the model's parameters and buffers (``model.<name>``),
each EMA's parameters (``ema_<rate>.<name>``) and ``model.json``, the class
and constructor kwargs that an npz checkpoint carries; ``opt.dcp/`` holds
AdamW's state of each trainable parameter (``<name>.step``,
``<name>.exp_avg``, ``<name>.exp_avg_sq``) and the update count
(``count``). A save writes ``<dir>.new`` and then replaces the old
directories. A load reads into whole tensors, so a run resumes at any
world size, with or without FSDP or tensor parallelism (the loop shards
after loading). Under tensor parallelism a rank's shards of a leaf cut
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

from ..model_base import ModelBase
from ..parallel.dist import is_primary
from ..parallel.tensor import global_tensor
from .ema import EMA
from .state import Optimizer

__all__ = ["load_emas", "load_model", "load_optimizer", "save_run"]

MANIFEST = "model.json"


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _keys(path: str) -> set:
    return set(dcp.FileSystemReader(path).read_metadata().state_dict_metadata)


def save_run(model_dir: str, opt_dir: str, model: ModelBase, emas: Sequence[EMA],
             optimizer: Optimizer, names: Sequence[str],
             tp_axes: Optional[Dict[str, int]] = None) -> None:
    """Write the model, its EMAs and the optimizer state (``names``: the
    optimizer's parameters' names, in its order; ``tp_axes``: {parameter
    name: axis} of those cut over the model group); every rank calls it."""
    tp_axes = tp_axes or {}

    def placed(name: str, t: torch.Tensor) -> torch.Tensor:
        return global_tensor(t, tp_axes[name]) if name in tp_axes and t.ndim else t

    model_state: Dict[str, torch.Tensor] = {
        f"model.{k}": placed(k, v) for k, v in model.state_dict().items()}
    for ema in emas:
        model_state.update((f"ema_{ema.rate}.{n}", placed(n, p))
                           for n, p in ema.model.named_parameters())
    opt_state: Dict[str, torch.Tensor] = {"count": torch.tensor(optimizer.count)}
    for n, p in zip(names, optimizer.params):
        opt_state.update((f"{n}.{k}", placed(n, v))
                         for k, v in optimizer.adamw.state.get(p, {}).items())
    for path, state in ((model_dir, model_state), (opt_dir, opt_state)):
        if is_primary() and os.path.exists(path + ".new"):
            shutil.rmtree(path + ".new")
        _barrier()
        dcp.save(state, checkpoint_id=path + ".new")
    _barrier()
    if is_primary():
        with open(os.path.join(model_dir + ".new", MANIFEST), "w") as f:
            json.dump({"class": model.class_name(), "kwargs": model.save_kwargs()}, f)
        for path in (model_dir, opt_dir):
            if os.path.exists(path):
                shutil.rmtree(path)
            os.replace(path + ".new", path)
    _barrier()


def load_model(path: str, cls: type) -> ModelBase:
    """The model of ``model.dcp`` (``cls`` or a subclass), on the CPU."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    model = cls.from_manifest(manifest["class"], manifest["kwargs"])
    state = {f"model.{k}": v.detach() for k, v in model.state_dict().items()}
    dcp.load(state, checkpoint_id=path)
    return model


def load_emas(path: str, emas: Sequence[EMA]) -> List[float]:
    """Load the EMAs that ``model.dcp`` holds; returns their rates."""
    keys = _keys(path)
    loaded = []
    for ema in emas:
        state = {f"ema_{ema.rate}.{n}": p.detach() for n, p in ema.model.named_parameters()}
        if all(k in keys for k in state):
            dcp.load(state, checkpoint_id=path)
            loaded.append(ema.rate)
    return loaded


def load_optimizer(path: str, optimizer: Optimizer, names: Sequence[str]) -> None:
    """Load ``opt.dcp`` into ``optimizer`` (whole tensors on its
    parameters' devices; the step counts on the CPU, as AdamW keeps them)."""
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
