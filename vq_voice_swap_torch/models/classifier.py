"""Diffusion-timestep-conditioned audio classifier (counterpart of
``vq_voice_swap_tpu/models/classifier.py``): a ResBlock stack conditioned
on t that halves the length after every level, an attention pool (a zero
token prepended, a 1x1 QKV projection, the output read at that token) and
a linear head. Classifier guidance differentiates it with respect to x.

Submodules carry the flax names (``stem``, ``time_embed_extra``,
``block_i``, ``pool/qkv_proj``, ``pool/c_proj``, ``head``), so checkpoints
map by rule (``convert/from_jax.py``). The attention is plain PyTorch, as
JAX computes it outside any Pallas kernel.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv1d, GroupNorm, ResBlock, TimeEmbedding, channels_first, gelu, linear

__all__ = ["AttentionPool1d", "ClassifierStem", "Classifier"]


class AttentionPool1d(nn.Module):
    """Attention pooling of [N, C, T] to [N, out_channels]: a zero token is
    prepended, every position is projected to (q, k, v) by a 1x1 conv,
    heads of ``head_channels`` attend with logits scaled by 1/sqrt(hc) in
    float32, and ``c_proj`` maps the zero token's output."""

    def __init__(self, channels: int, head_channels: int = 64,
                 out_channels: Optional[int] = None):
        super().__init__()
        if channels % head_channels:
            raise ValueError(f"{channels} channels do not split into heads of "
                             f"{head_channels}")
        self.head_channels = head_channels
        self.qkv_proj = Conv1d(channels, 3 * channels, 1)
        self.c_proj = Conv1d(channels, out_channels or channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, t = x.shape
        heads, hc = c // self.head_channels, self.head_channels
        x = torch.cat([torch.zeros_like(x[:, :, :1]), x], dim=2)  # [N, C, T+1]
        q, k, v = self.qkv_proj(x).chunk(3, dim=1)
        # Only the zero token's output is read, and every step after the
        # attention is per position, so only its query is formed.
        scale = 1.0 / math.sqrt(math.sqrt(hc))
        q = q[:, :, :1].reshape(n, heads, hc, 1)
        k = k.reshape(n, heads, hc, t + 1)
        v = v.reshape(n, heads, hc, t + 1)
        logits = torch.einsum("nhcq,nhck->nhqk", (q * scale).float(), (k * scale).float())
        weights = F.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("nhqk,nhck->nhcq", weights, v).reshape(n, c, 1)
        return self.c_proj(out)[:, :, 0]


class ClassifierStem(nn.Module):
    """[N, T, 1] + ts -> [N, base_channels * output_mult] float32 features.
    ``dtype`` is the compute dtype (None = float32)."""

    def __init__(
        self,
        base_channels: int = 32,
        channel_mult: Sequence[int] = (1, 1, 2, 2, 2, 4, 4, 8, 8),
        output_mult: int = 16,
        depth_mult: int = 2,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        ch = base_channels
        embed_dim = ch * 4
        self.dtype = dtype
        self.time_embed = TimeEmbedding(embed_dim)
        self.time_embed_extra = nn.Linear(embed_dim, embed_dim)
        self.in_conv = Conv1d(1, ch, 3)
        blocks = []
        cur = ch
        for mult in channel_mult:
            for _ in range(depth_mult):
                blocks.append(ResBlock(cur, mult * ch, embed_dim))
                cur = mult * ch
            blocks.append(ResBlock(cur, emb_channels=embed_dim, scale_factor=0.5))
        self.block = nn.ModuleList(blocks)
        self.out_norm = GroupNorm(cur, use_gelu=True)
        self.pool = AttentionPool1d(cur, min(cur, 64), ch * output_mult)

    def forward(self, x: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.float32
        emb = linear(gelu(self.time_embed(ts, dtype)), self.time_embed_extra)
        h = self.in_conv(channels_first(x, dtype))
        for b in self.block:
            h = b(h, emb)
        return self.pool(self.out_norm(h)).float()


class Classifier(nn.Module):
    """The stem and a linear head: [N, T, 1] + ts -> [N, num_labels]
    float32 logits. ``features`` is the stem's output, which the eval
    statistics are taken of, and ``head_from_features`` the logits of it."""

    def __init__(
        self,
        num_labels: int,
        base_channels: int = 32,
        channel_mult: Sequence[int] = (1, 1, 2, 2, 2, 4, 4, 8, 8),
        output_mult: int = 16,
        depth_mult: int = 2,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.stem = ClassifierStem(base_channels, channel_mult, output_mult, depth_mult, dtype)
        self.head = nn.Linear(base_channels * output_mult, num_labels)

    def features(self, x: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        return self.stem(x, ts)

    def head_from_features(self, features: torch.Tensor) -> torch.Tensor:
        return self.head(gelu(features))

    def forward(self, x: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        return self.head_from_features(self.features(x, ts))
