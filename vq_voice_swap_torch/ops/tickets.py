"""Ticket counters for the CUDA kernels that merge across blocks.

``csrc/vq_assign.cu`` and ``csrc/group_norm_stats.cu`` elect the last
block of a merge span with a ticket: each block ``atomicAdd``s the span's
counter after writing its partial, and the block that draws the last ticket
merges the partials and resets that counter to 0. So a buffer is zeroed
once, when it is made, and no launch clears it.

One buffer serves one (device, stream). Kernels launched on one stream run
one after another, so no two of them hold the same counters at once;
kernels on two streams get two buffers. A launch that fails to start runs
no block and touches no counter. A kernel that faults after taking a ticket
leaves the CUDA context unusable (every later CUDA call raises), so no
later launch reads its counters.
"""

from typing import Dict, List, Tuple

import torch

__all__ = ["tickets", "ticket_buffers"]

_BUFFERS: Dict[Tuple[int, int], torch.Tensor] = {}


def tickets(stream: torch.cuda.Stream, count: int) -> torch.Tensor:
    """At least ``count`` int32 counters, all 0 between launches, for the
    kernels launched on ``stream``. A buffer is made outside CUDA graph
    capture: launch once on the capturing stream before capturing."""
    key = (stream.device_index, stream.cuda_stream)
    buf = _BUFFERS.get(key)
    if buf is None or buf.numel() < count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("ticket counters for this stream do not exist yet: launch "
                               "the kernel once on the capturing stream before capture")
        with torch.cuda.stream(stream):
            buf = torch.zeros(max(count, 4096), dtype=torch.int32, device=stream.device)
        _BUFFERS[key] = buf
    return buf


def ticket_buffers() -> List[torch.Tensor]:
    """Every ticket buffer made so far (all zeros unless a launch is in
    flight), for checks."""
    return list(_BUFFERS.values())
