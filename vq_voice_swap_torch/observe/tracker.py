"""Windowed per-timestep-quantile loss tracking (counterpart of
``vq_voice_swap_tpu/observe/tracker.py``): per-element losses are bucketed
by their timestep's quantile, and each bucket reports the mean of its most
recent ``avg_size`` entries."""

from collections import deque
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LossTracker"]


class LossTracker:
    def __init__(self, quantiles: int = 4, avg_size: int = 1000, prefix: str = ""):
        self.quantiles = quantiles
        self.avg_size = avg_size
        self.prefix = prefix
        self.history: List[deque] = [deque(maxlen=avg_size) for _ in range(quantiles)]

    def add(self, ts, losses) -> None:
        """ts and losses: arrays of one value per element (numpy, or CPU
        tensors). The buckets are taken in float64, so ts == 1.0 lands in
        the last one."""
        ts = np.asarray(ts, np.float64).reshape(-1)
        losses = np.asarray(losses).reshape(-1)
        buckets = (ts * (self.quantiles - 1e-8)).astype(np.int64)
        for q in range(self.quantiles):
            sel = losses[buckets == q]
            if sel.size:
                self.history[q].extend(sel.tolist())

    def quantile_averages(self) -> List[Optional[float]]:
        return [float(np.mean(h)) if len(h) else None for h in self.history]

    def log_dict(self) -> Dict[str, float]:
        return {
            f"{self.prefix}q{i}": avg
            for i, avg in enumerate(self.quantile_averages())
            if avg is not None
        }
