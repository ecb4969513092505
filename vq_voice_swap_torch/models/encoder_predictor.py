"""Predict VQ codes from noised audio, for encoder-predictor guidance
(counterpart of ``vq_voice_swap_tpu/models/encoder_predictor.py``): a UNet
with a bottleneck output, nearest-resized to T / downsample_rate, then a
1x1 conv to per-position code logits. Guidance differentiates its
cross-entropy against the clip's own codes with respect to x."""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv1d, nearest_resize_1d
from .unet import UNetPredictor

__all__ = ["EncoderPredictor"]


class EncoderPredictor(nn.Module):
    """[N, T, 1] + ts -> [N, T // downsample_rate, num_latents] float32
    logits. ``dtype`` is the UNet's compute dtype; ``out_proj`` runs in
    float32, as in the JAX module."""

    def __init__(
        self,
        base_channels: int,
        downsample_rate: int,
        num_latents: int,
        bottleneck_dim: int = 64,
        channel_mult: Sequence[int] = (1, 1, 2, 2, 2, 4, 4, 8, 8),
        depth_mult: int = 2,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.downsample_rate = downsample_rate
        self.unet = UNetPredictor(
            base_channels=base_channels,
            channel_mult=channel_mult,
            depth_mult=depth_mult,
            out_channels=bottleneck_dim,
            dtype=dtype,
        )
        self.out_proj = Conv1d(bottleneck_dim, num_latents, 1)

    def forward(self, x: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        h = self.unet(x, ts).transpose(1, 2)  # [N, bottleneck, T] float32
        h = nearest_resize_1d(h, h.shape[-1] // self.downsample_rate)
        return self.out_proj(h).transpose(1, 2)

    def losses(self, x: torch.Tensor, ts: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Per-item mean cross-entropy against targets [N, T1] ints."""
        logp = F.log_softmax(self(x, ts), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        return nll.mean(dim=-1)
