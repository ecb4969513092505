"""Moving averages for plotting (counterpart of
``vq_voice_swap_tpu/observe/smoothing.py``)."""

import numpy as np

__all__ = ["moving_average"]


def moving_average(xs: np.ndarray, window_size: int) -> np.ndarray:
    """Trailing moving average; entry k averages xs[max(0, k-w+1) .. k]."""
    xs = np.asarray(xs, dtype=np.float64)
    if len(xs) <= window_size:
        return np.cumsum(xs) / (np.arange(len(xs)) + 1)
    head = np.cumsum(xs)[: window_size - 1] / (np.arange(window_size - 1) + 1)
    body = np.convolve(
        xs, np.full(window_size, 1.0 / window_size), mode="valid"
    )
    return np.concatenate([head, body])
