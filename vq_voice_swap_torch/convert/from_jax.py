"""Map the JAX package's flat checkpoint arrays onto this port's modules.

The port names its torch submodules after the flax paths, so the mapping is
a rule rather than a table:

- ``params/`` and ``buffers/`` prefixes are dropped;
- a path component ending in ``_<digits>`` is a list entry:
  ``down_blocks_3`` -> ``down_blocks.3``, ``res_3_0`` -> ``res_3.0``;
- leaves: flax conv ``kernel`` (K, C_in, C_out) -> ``weight``
  (C_out, C_in, K); Dense ``kernel`` (in, out) -> Linear ``weight``
  (out, in); GroupNorm and LayerNorm ``scale`` -> ``weight``; Embed
  ``embedding`` -> ``weight``; every other leaf keeps its name and layout.

``params_to_jax`` is the inverse, read off the module types.
"""

import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_jax", "params_to_jax", "torch_key"]

_LIST_ENTRY = re.compile(r"^(.*)_(\d+)$")
_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def torch_key(path: str) -> str:
    """"params/predictor/down_blocks_3/norm_in/norm/scale" ->
    "predictor.down_blocks.3.norm_in.norm.weight"."""
    _collection, *parts = path.split("/")
    *modules, leaf = parts
    out = []
    for name in modules:
        m = _LIST_ENTRY.match(name)
        out.extend(m.groups() if m else (name,))
    out.append(_LEAF_TO_TORCH.get(leaf, leaf))
    return ".".join(out)


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX checkpoint arrays -> a state_dict for the port's modules."""
    state = {}
    for path, arr in flat.items():
        arr = np.asarray(arr)
        if path.rsplit("/", 1)[-1] == "kernel":
            arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
        state[torch_key(path)] = torch.from_numpy(np.array(arr, order="C"))
    return state


def _jax_module_path(name: str) -> list:
    parts = []
    for p in name.split(".") if name else []:
        if p.isdigit():
            parts[-1] = f"{parts[-1]}_{p}"
        else:
            parts.append(p)
    return parts


def params_to_jax(model: nn.Module,
                  state: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, np.ndarray]:
    """The port's parameters and buffers -> flat JAX checkpoint arrays;
    ``state`` (a state_dict of the model's, e.g. a snapshot) replaces the
    module's own tensors."""
    flat = {}
    for name, module in model.named_modules():
        prefix = _jax_module_path(name)
        for collection, tensors in (
            ("params", module.named_parameters(recurse=False)),
            ("buffers", module.named_buffers(recurse=False)),
        ):
            for leaf, t in tensors:
                if state is not None:
                    t = state[f"{name}.{leaf}" if name else leaf]
                arr = t.detach().cpu().numpy()
                if leaf == "weight" and isinstance(module, (nn.Conv1d, nn.Linear)):
                    leaf = "kernel"
                    arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
                elif leaf == "weight" and isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
                    leaf = "scale"
                elif leaf == "weight" and isinstance(module, nn.Embedding):
                    leaf = "embedding"
                key = "/".join([collection, *prefix, leaf])
                flat[key] = np.ascontiguousarray(arr)
    return flat
