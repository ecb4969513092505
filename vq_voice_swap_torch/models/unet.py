"""1-D UNet epsilon-predictor and encoder (counterpart of
``vq_voice_swap_tpu/models/unet.py``, without remat or int8 storage).

Public inputs and outputs are channel-last [N, T, C]; the blocks run on
[N, C, T]. ``dtype`` is the compute dtype (None = float32): inputs are cast
to it, parameters stay float32 and are cast per op, and the output is
float32.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import (
    Conv1d,
    GroupNorm,
    ResBlock,
    TimeEmbedding,
    channels_first,
    gelu,
    linear,
    nearest_resize_1d,
)

__all__ = ["UNetPredictor", "UNetEncoder"]


class UNetPredictor(nn.Module):
    """The flagship epsilon predictor.

    x: [N, T, in_channels]; ts: [N] in [0, 1]; cond (iff cond_channels):
    [N, T1, cond_channels]; labels (iff num_labels): [N] ints.
    Output: [N, T, out_channels] float32.
    """

    def __init__(
        self,
        base_channels: int,
        channel_mult: Sequence[int] = (1, 1, 2, 2, 2, 4, 4, 8, 8),
        middle_dilations: Sequence[int] = (4, 8, 16, 32),
        depth_mult: int = 2,
        cond_channels: Optional[int] = None,
        num_labels: Optional[int] = None,
        in_channels: int = 1,
        out_channels: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        ch = base_channels
        embed_dim = ch * 4
        self.channel_mult = tuple(channel_mult)
        self.depth_mult = depth_mult
        self.cond_channels = cond_channels
        self.num_labels = num_labels
        self.dtype = dtype

        self.time_embed = TimeEmbedding(embed_dim)
        self.time_embed_extra = nn.Linear(embed_dim, embed_dim)
        if num_labels is not None:
            self.class_embed = nn.Embedding(num_labels, embed_dim)
        if cond_channels is not None:
            self.cond_proj = Conv1d(cond_channels, ch, 3)
        self.in_conv = Conv1d(in_channels, ch, 3)

        skip_chs = [ch]
        cur = ch
        down = []
        for depth, mult in enumerate(self.channel_mult):
            for _ in range(depth_mult):
                down.append(ResBlock(cur, mult * ch, embed_dim))
                cur = mult * ch
                skip_chs.append(cur)
            if depth != len(self.channel_mult) - 1:
                down.append(ResBlock(cur, emb_channels=embed_dim, scale_factor=0.5))
                skip_chs.append(cur)
        self.down_blocks = nn.ModuleList(down)

        self.middle_blocks = nn.ModuleList(
            ResBlock(cur, emb_channels=embed_dim, dilation=d)
            for d in middle_dilations
        )

        up = []
        for depth, mult in list(enumerate(self.channel_mult))[::-1]:
            for _ in range(depth_mult + 1):
                up.append(ResBlock(cur + skip_chs.pop(), mult * ch, embed_dim))
                cur = mult * ch
            if depth:
                up.append(ResBlock(cur, emb_channels=embed_dim, scale_factor=2.0))
        self.up_blocks = nn.ModuleList(up)

        self.out_norm = GroupNorm(cur, use_gelu=True)
        self.out_conv = Conv1d(cur, out_channels, 3)

    @property
    def downsample_rate(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)

    def forward(
        self,
        x: torch.Tensor,
        ts: torch.Tensor,
        cond: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if (labels is None) != (self.num_labels is None):
            raise ValueError("pass labels iff the model is class-conditional")
        if (cond is None) != (self.cond_channels is None):
            raise ValueError("pass a cond sequence iff the model is conditional")
        dtype = self.dtype or torch.float32

        emb = linear(gelu(self.time_embed(ts, dtype)), self.time_embed_extra)
        if labels is not None:
            emb = emb + self.class_embed(labels).to(dtype)

        h = self.in_conv(channels_first(x, dtype))
        if cond is not None:
            c = self.cond_proj(channels_first(cond, dtype))
            h = h + nearest_resize_1d(c, h.shape[-1])

        skips = [h]
        for b in self.down_blocks:
            h = b(h, emb)
            skips.append(h)
        for b in self.middle_blocks:
            h = b(h, emb)
        for i, b in enumerate(self.up_blocks):
            # Upsampling blocks (every depth_mult+2-th) take no skip concat.
            if i % (self.depth_mult + 2) != self.depth_mult + 1:
                h = torch.cat([h, skips.pop()], dim=1)
            h = b(h, emb)

        h = self.out_conv(self.out_norm(h))
        return h.transpose(1, 2).float()


class UNetEncoder(nn.Module):
    """Down-only UNet stack used as a VQ-VAE encoder, with optional
    trailing dilated blocks. x: [N, T, in_channels] -> [N, T1, out_channels]."""

    def __init__(
        self,
        base_channels: int,
        channel_mult: Sequence[int] = (1, 1, 2, 2, 2, 4, 4, 8, 8),
        out_dilations: Sequence[int] = (),
        depth_mult: int = 2,
        in_channels: int = 1,
        out_channels: int = 512,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        ch = base_channels
        self.channel_mult = tuple(channel_mult)
        self.dtype = dtype
        self.in_conv = Conv1d(in_channels, ch, 3)
        blocks = []
        cur = ch
        for depth, mult in enumerate(self.channel_mult):
            for _ in range(depth_mult):
                blocks.append(ResBlock(cur, mult * ch))
                cur = mult * ch
            if depth != len(self.channel_mult) - 1:
                blocks.append(ResBlock(cur, scale_factor=0.5))
        for d in out_dilations:
            blocks.append(ResBlock(cur, dilation=d))
        self.blocks = nn.ModuleList(blocks)
        self.out_norm = GroupNorm(cur, use_gelu=True)
        self.out_conv = Conv1d(cur, out_channels, 3)

    @property
    def downsample_rate(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(channels_first(x, self.dtype or torch.float32))
        for b in self.blocks:
            h = b(h)
        h = self.out_conv(self.out_norm(h))
        return h.transpose(1, 2).float()
