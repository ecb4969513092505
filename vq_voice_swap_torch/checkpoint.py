"""Self-describing single-file ``.npz`` checkpoints, in the JAX package's
format so either package reads what the other wrote.

A checkpoint holds a ``__meta__`` JSON entry (format version, class name,
constructor kwargs) plus one array per variable, keyed by its "/"-joined
path within its collection (``params/...``, ``buffers/...``). Saves are
atomic (temp file + fsync + rename).
"""

import json
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]

_META_KEY = "__meta__"
_FORMAT_VERSION = 1


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
