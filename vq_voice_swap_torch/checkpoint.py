"""Self-describing single-file ``.npz`` checkpoints, in the JAX package's
format so either package reads what the other wrote.

A checkpoint holds a ``__meta__`` JSON entry (format version, class name,
constructor kwargs) plus one array per variable, keyed by its "/"-joined
path within its collection (``params/...``, ``buffers/...``). Saves are
atomic (temp file + fsync + rename).

``load_dcp_checkpoint`` reads the sharded directory format that
``train/dcp.py`` writes (``--checkpoint-format dcp``): a model (or one
EMA's) directory holds ``model.json`` (class and kwargs) and its tensors
under ``model.<state_dict key>``. It reads on one process, with no process
group, into whole CPU tensors; like the JAX package's Orbax loader it falls
back to a complete ``<path>.new`` when ``<path>`` is missing
(``staged_fallback``: a crash hit the commit window of a save).
"""

import json
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "load_dcp_checkpoint", "staged_fallback",
           "DCP_MANIFEST"]

_META_KEY = "__meta__"
_FORMAT_VERSION = 1
DCP_MANIFEST = "model.json"


def save_checkpoint(
    path: str,
    class_name: str,
    kwargs: Dict[str, Any],
    arrays: Dict[str, np.ndarray],
) -> None:
    """Atomically write ``arrays`` (flat "collection/a/b" keys) with a
    manifest naming the class and its constructor kwargs."""
    meta = {"format": _FORMAT_VERSION, "class": class_name, "kwargs": kwargs}
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{_META_KEY: np.asarray(json.dumps(meta)), **arrays})
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o644)
        os.rename(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]:
    """Read a checkpoint -> (class_name, kwargs, flat arrays)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data[_META_KEY]))
        flat = {k: data[k] for k in data.files if k != _META_KEY}
    return meta["class"], meta["kwargs"], flat


def staged_fallback(path: str) -> str:
    """The committed checkpoint directory, or its complete ``.new`` staging
    directory when a crash hit the swap window of a save (``path`` missing,
    ``path.new`` complete), as the JAX package's ``staged_fallback``."""
    if not os.path.exists(path) and os.path.isdir(path + ".new"):
        return path + ".new"
    return path


def load_dcp_checkpoint(path: str) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    """(class name, kwargs, state_dict) of a dcp model directory, read on
    this process alone into whole CPU tensors (any world size, sharded or
    not, wrote it)."""
    import warnings

    import torch
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = staged_fallback(path)
    if not os.path.isfile(os.path.join(path, DCP_MANIFEST)):
        raise ValueError(f"{path} is a directory without {DCP_MANIFEST}: not a "
                         "--checkpoint-format dcp model directory (this port reads npz, "
                         "reference .pt and dcp checkpoints)")
    with open(os.path.join(path, DCP_MANIFEST)) as f:
        manifest = json.load(f)
    metadata = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    state = {k: torch.empty(m.size, dtype=m.properties.dtype) for k, m in metadata.items()
             if k.startswith("model.") and isinstance(m, TensorStorageMetadata)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the single-process read is meant
        dcp.load(state, checkpoint_id=path, no_dist=True)
    return manifest["class"], manifest["kwargs"], {k[len("model."):]: v
                                                   for k, v in state.items()}
