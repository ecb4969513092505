"""The window gather of the data loader (counterpart of
``vq_voice_swap_tpu/data/native.py``): [N] spans of a float32 arena into
an [N, window] batch, each row zero-padded past its available samples.

``batch_gather_windows`` runs the package's own C source
(``csrc/audio_gather.c``), built at first use with the host C compiler
(``ops/cuda_build.py``) and called through ``ctypes``, which releases the
interpreter lock for the copy. A failed build raises: there is no silent
fallback. ``batch_gather_windows_plain`` is the numpy loop it is held
against.
"""

import ctypes

import numpy as np

from ..ops.cuda_build import load_library

__all__ = ["batch_gather_windows", "batch_gather_windows_plain"]

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def _library() -> ctypes.CDLL:
    lib = load_library("audio_gather")
    fn = lib.gather_windows
    if fn.restype is not ctypes.c_int64:
        fn.argtypes = [_F32P, ctypes.c_int64, _I64P, _I64P, ctypes.c_int64,
                       ctypes.c_int64, _F32P]
        fn.restype = ctypes.c_int64
    return lib


def _spans(starts: np.ndarray, avail: np.ndarray):
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    avail = np.ascontiguousarray(avail, dtype=np.int64)
    if starts.shape != avail.shape or starts.ndim != 1:
        raise ValueError(f"starts {starts.shape} and avail {avail.shape} must be "
                         "equal 1-d arrays")
    return starts, avail


def batch_gather_windows(arena: np.ndarray, starts: np.ndarray, avail: np.ndarray,
                         window: int) -> np.ndarray:
    """[N, window] float32 rows ``arena[starts[i]:starts[i] + avail[i]]``
    (at most ``window`` of them), zero-padded. Raises ValueError for a row
    outside the arena, before anything is copied."""
    if arena.dtype != np.float32 or arena.ndim != 1 or not arena.flags.c_contiguous:
        raise ValueError(f"the arena must be a contiguous 1-d float32 array, got "
                         f"{arena.dtype} {arena.shape}")
    starts, avail = _spans(starts, avail)
    out = np.empty((len(starts), window), dtype=np.float32)
    bad = _library().gather_windows(
        arena.ctypes.data_as(_F32P), len(arena), starts.ctypes.data_as(_I64P),
        avail.ctypes.data_as(_I64P), len(starts), window, out.ctypes.data_as(_F32P))
    if bad:
        raise ValueError(f"window out of arena bounds: row {bad - 1} (start "
                         f"{starts[bad - 1]}, {avail[bad - 1]} samples) of an arena of "
                         f"{len(arena)}")
    return out


def batch_gather_windows_plain(arena: np.ndarray, starts: np.ndarray, avail: np.ndarray,
                               window: int) -> np.ndarray:
    """``batch_gather_windows`` as a numpy loop."""
    starts, avail = _spans(starts, avail)
    out = np.zeros((len(starts), window), dtype=np.float32)
    for i, (s, n) in enumerate(zip(starts.tolist(), avail.tolist())):
        n = min(n, window)
        if s < 0 or n < 0 or s + n > len(arena):
            raise ValueError(f"window out of arena bounds: row {i} (start {s}, {n} "
                             f"samples) of an arena of {len(arena)}")
        out[i, :n] = arena[s:s + n]
    return out
