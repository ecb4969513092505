"""Vector quantization against a learned codebook (counterpart of
``vq_voice_swap_tpu/vq.py``; usage tracking and dead-code revival belong
to training and come with it)."""

from typing import Dict, Optional

import torch
from torch import nn

from .ops.vq_assign import vq_assign

__all__ = ["Codebook", "embedding_distances", "vq_forward", "init_vq_params"]


def embedding_distances(dictionary: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between rows of x [..., C] and a [D, C]
    codebook, as |x|^2 - 2 x.d + |d|^2 in float32."""
    x = x.float()
    d = dictionary.float()
    dots = torch.matmul(x, d.t())
    return -2.0 * dots + torch.sum(d * d, dim=-1) + torch.sum(x * x, dim=-1)[..., None]


def vq_forward(dictionary: torch.Tensor, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Quantize x [N, T, C] against a [D, C] codebook.

    Returns "embedded" (codebook rows), "passthrough" (straight-through
    output), "idxs" ([N, T] int64) and "used" ([D] bool). The assignment
    runs the VQ kernel on CUDA (ops/vq_assign.py)."""
    flat = x.detach().reshape(-1, x.shape[-1]).float().contiguous()
    idxs_flat, used = vq_assign(dictionary.detach().contiguous(), flat)
    idxs = idxs_flat.long().reshape(x.shape[:-1])
    embedded = dictionary[idxs]
    passthrough = x + (embedded - x).detach()
    return {
        "embedded": embedded,
        "passthrough": passthrough,
        "idxs": idxs,
        "used": used.bool(),
    }


def init_vq_params(
    num_codes: int,
    num_channels: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Gaussian-initialised [D, C] codebook."""
    return torch.randn(
        (num_codes, num_channels), generator=generator, device=device
    )


class Codebook(nn.Module):
    """The [D, C] dictionary and the per-code usage counter (a buffer,
    carried for the checkpoint; training updates it)."""

    def __init__(self, num_codes: int, num_channels: int, dead_rate: int):
        super().__init__()
        self.dictionary = nn.Parameter(init_vq_params(num_codes, num_channels))
        self.register_buffer(
            "usage_count", torch.full((num_codes,), dead_rate, dtype=torch.int32)
        )
