"""Vector quantization against a learned codebook, with the training-side
codebook maintenance (counterpart of ``vq_voice_swap_tpu/vq.py``):
nearest-code assignment with a straight-through output, usage tracking
with a dead_rate horizon, k-means++ revival of dead codes from the current
batch, and the codebook + commitment (+ revival) loss."""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .ops.vq_assign import vq_assign

__all__ = [
    "Codebook",
    "VQLossConfig",
    "embedding_distances",
    "draw_revival_picks",
    "init_vq_params",
    "revival_probs",
    "revive_dead_codes",
    "update_usage",
    "vq_forward",
    "vq_loss_fn",
]


def embedding_distances(dictionary: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between rows of x [..., C] and a [D, C]
    codebook, as |x|^2 - 2 x.d + |d|^2 in float32."""
    x = x.float()
    d = dictionary.float()
    dots = torch.matmul(x, d.t())
    return -2.0 * dots + torch.sum(d * d, dim=-1) + torch.sum(x * x, dim=-1)[..., None]


def vq_forward(dictionary: torch.Tensor, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Quantize x [N, T, C] against a [D, C] codebook.

    Returns "embedded" (codebook rows; gradients reach the dictionary),
    "passthrough" (straight-through output; gradients reach x), "idxs"
    ([N, T] int64) and "used" ([D] bool). The assignment runs the VQ kernel
    on CUDA (ops/vq_assign.py) on detached inputs."""
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


def update_usage(
    usage: torch.Tensor,
    idxs: torch.Tensor,
    dead_rate: int,
    decay: int = 1,
    used: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Used codes go to dead_rate; the others decay by ``decay`` (the
    number of microbatch forwards of the step), clipped to [0, dead_rate].
    ``used`` is the [D] bool mask of vq_forward; without it the mask is
    scattered from idxs."""
    if used is None:
        used = torch.zeros(usage.shape[0], dtype=torch.bool, device=usage.device)
        used[idxs.reshape(-1)] = True
    return torch.where(used, torch.full_like(usage, dead_rate),
                       torch.clamp(usage - decay, 0, dead_rate))


def revival_probs(dictionary: torch.Tensor, batch_vecs: torch.Tensor) -> torch.Tensor:
    """k-means++ weights over the rows of batch_vecs [B, C]: each row's
    squared distance to its nearest code, or uniform when all are 0."""
    probs = torch.clamp(embedding_distances(dictionary, batch_vecs).min(dim=-1).values, min=0.0)
    return torch.where(probs.sum() > 0, probs, torch.ones_like(probs))


def draw_revival_picks(probs: torch.Tensor, num_codes: int,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One categorical draw of a row index per code, from ``revival_probs``."""
    return torch.multinomial(probs, num_codes, replacement=True, generator=generator)


def revive_dead_codes(
    dictionary: torch.Tensor,
    usage: torch.Tensor,
    batch_vecs: torch.Tensor,
    dead_rate: int,
    generator: Optional[torch.Generator] = None,
    picks: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-initialise dead codes (usage 0) from the current batch: one
    categorical draw of a row of batch_vecs per code, with probabilities
    from ``revival_probs``. ``picks`` ([D] row indices) replaces the draw
    from ``generator``. Returns (new_dictionary, new_usage)."""
    if picks is None:
        picks = draw_revival_picks(revival_probs(dictionary, batch_vecs), dictionary.shape[0],
                                   generator)
    dead = usage == 0
    replacements = batch_vecs[picks].to(dictionary.dtype)
    new_dict = torch.where(dead[:, None], replacements, dictionary)
    new_usage = torch.where(dead, torch.full_like(usage, dead_rate), usage)
    return new_dict, new_usage


@dataclass(frozen=True)
class VQLossConfig:
    """commitment: the coefficient of the encoder-commitment term.
    revival: when > 0, adds revival * the mean distance of every code to
    the batch; when 0 the train step revives dead codes instead."""

    commitment: float = 0.25
    revival: float = 0.0


def vq_loss_fn(
    cfg: VQLossConfig,
    inputs: torch.Tensor,
    embedded: torch.Tensor,
    dictionary: torch.Tensor,
) -> torch.Tensor:
    """Codebook + commitment (+ optional revival) loss."""
    codebook_loss = torch.mean(torch.square(inputs.detach() - embedded))
    commit_loss = torch.mean(torch.square(inputs - embedded.detach()))
    loss = codebook_loss + cfg.commitment * commit_loss
    if cfg.revival:
        flat = inputs.reshape(-1, inputs.shape[-1])
        loss = loss + cfg.revival * torch.mean(embedding_distances(dictionary, flat))
    return loss


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
    """The [D, C] dictionary and the per-code usage counter (a buffer that
    the train step maintains and checkpoints carry as
    ``buffers/vq/usage_count``)."""

    def __init__(self, num_codes: int, num_channels: int, dead_rate: int):
        super().__init__()
        self.dictionary = nn.Parameter(init_vq_params(num_codes, num_channels))
        self.register_buffer(
            "usage_count", torch.full((num_codes,), dead_rate, dtype=torch.int32)
        )
