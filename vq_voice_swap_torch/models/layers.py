"""Shared building blocks of the 1-D audio models, on [N, C, T] activations.

Counterpart of ``vq_voice_swap_tpu/models/layers.py`` without its int8
(``QAct``) branches. Submodules carry the flax names (``conv``, ``norm``,
``proj``, ``cond_proj``, ...) so checkpoints map by rule
(``convert/from_jax.py``). Parameters stay float32; a module computes in
its input's dtype and casts each parameter per op, as flax does with a
compute ``dtype``. GroupNorm statistics are float32 whatever the dtype.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.group_norm import group_norm

__all__ = [
    "gelu",
    "adaptive_group_count",
    "channels_first",
    "conv1d",
    "linear",
    "Conv1d",
    "GroupNorm",
    "sinusoidal_time_features",
    "TimeEmbedding",
    "avg_pool_1d",
    "nearest_upsample_1d",
    "nearest_resize_1d",
    "ResBlock",
]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU."""
    return F.gelu(x)


def adaptive_group_count(ch: int, max_groups: int = 32) -> int:
    """Largest power-of-two group count <= max_groups dividing ch."""
    g = max_groups
    while ch % g:
        g //= 2
    return g


def channels_first(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[N, T, C] -> contiguous [N, C, T] in dtype. Always a copy: with C=1
    a transposed view passes is_contiguous(), yet conv1d then returns a
    channels-last result, which the GroupNorm kernels do not take."""
    return x.to(dtype).transpose(1, 2).clone(memory_format=torch.contiguous_format)


def conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """Run ``conv`` on [N, C, T] in x's dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv1d(
        x, conv.weight.to(x.dtype), bias, stride=conv.stride,
        padding=conv.padding, dilation=conv.dilation,
    )


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """Run ``lin`` in x's dtype."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


class Conv1d(nn.Module):
    """1-D convolution with 'SAME'-style padding (k-1)*dilation//2."""

    def __init__(
        self, in_channels: int, features: int, kernel_size: int = 3,
        dilation: int = 1,
    ):
        super().__init__()
        self.conv = nn.Conv1d(
            in_channels, features, kernel_size, dilation=dilation,
            padding=(kernel_size - 1) * dilation // 2,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.conv)


class GroupNorm(nn.Module):
    """GroupNorm over the channels of [N, C, T] with the adaptive group
    count, eps 1e-5, float32 statistics, optionally followed by a FiLM
    h*(ca+1)+cb and exact GELU — all one stats and one apply kernel on the
    card (ops/group_norm.py). ``norm`` holds the affine weight and bias."""

    def __init__(
        self, channels: int, max_groups: int = 32, eps: float = 1e-5,
        use_gelu: bool = False,
    ):
        super().__init__()
        self.norm = nn.GroupNorm(
            adaptive_group_count(channels, max_groups), channels, eps=eps
        )
        self.use_gelu = use_gelu

    def forward(
        self,
        x: torch.Tensor,
        film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        return group_norm(
            x, self.norm.weight, self.norm.bias, self.norm.num_groups,
            self.norm.eps, self.use_gelu, film,
        )


def sinusoidal_time_features(ts: torch.Tensor, channels: int) -> torch.Tensor:
    """[N] ts in [0, 1] -> [N, channels] cos/sin features with frequencies
    geometric in [0.1, 100]."""
    if channels % 2:
        raise ValueError("time-embedding channels must be even")
    half = channels // 2
    min_coeff, max_coeff = 0.1, 100.0
    exponents = torch.arange(half, dtype=torch.float32, device=ts.device) / (
        half - 1
    )
    freqs = max_coeff * torch.exp(-math.log(max_coeff / min_coeff) * exponents)
    args = ts.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimeEmbedding(nn.Module):
    """Sinusoidal timestep features followed by a linear projection."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.proj = nn.Linear(channels, channels)

    def forward(self, ts: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        emb = sinusoidal_time_features(ts, self.channels).to(dtype)
        return linear(emb, self.proj)


def avg_pool_1d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Non-overlapping average pooling over the T axis of [N, C, T]."""
    n, c, t = x.shape
    if t % factor:
        raise ValueError(f"length {t} not divisible by pool factor {factor}")
    return x.reshape(n, c, t // factor, factor).mean(dim=-1)


def nearest_upsample_1d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling over the T axis of [N, C, T]."""
    return torch.repeat_interleave(x, factor, dim=-1)


def nearest_resize_1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest-neighbour resize of [N, C, T] to [N, C, out_len], with the
    source index floor(i * (T / out_len)) computed in float32 as the JAX
    package computes it."""
    t = x.shape[-1]
    if t == out_len:
        return x
    pos = torch.arange(out_len, dtype=torch.float32, device=x.device) * (
        t / out_len
    )
    return torch.index_select(x, -1, torch.floor(pos).long())


class ResBlock(nn.Module):
    """The UNet residual block: [GroupNorm+GELU, resize, conv3, GroupNorm]
    -> optional FiLM h*(a+1)+b from an embedding -> [GELU, dilated conv3];
    the skip path resizes and 1x1-projects when channels change.
    scale_factor 1.0 = identity, 0.5 = avg-pool x2, 2.0 = nearest x2 up.

    ``norm_mid`` carries the GELU that follows the FiLM, so norm, FiLM and
    GELU are one apply kernel. Dropout is identity at inference and is not
    part of this serving port.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        emb_channels: Optional[int] = None,
        scale_factor: float = 1.0,
        dilation: int = 2,
    ):
        super().__init__()
        out_ch = out_channels or in_channels
        self.scale_factor = scale_factor
        self.norm_in = GroupNorm(in_channels, use_gelu=True)
        self.conv_in = Conv1d(in_channels, out_ch, 3)
        self.norm_mid = GroupNorm(out_ch, use_gelu=True)
        self.cond_proj = (
            nn.Linear(emb_channels, out_ch * 2) if emb_channels else None
        )
        self.conv_out = Conv1d(out_ch, out_ch, 3, dilation=dilation)
        self.skip_proj = (
            Conv1d(in_channels, out_ch, 1) if in_channels != out_ch else None
        )

    def _resize(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale_factor == 1.0:
            return x
        if self.scale_factor < 1.0:
            return avg_pool_1d(x, int(round(1.0 / self.scale_factor)))
        return nearest_upsample_1d(x, int(round(self.scale_factor)))

    def forward(
        self, x: torch.Tensor, emb: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if (emb is not None) != (self.cond_proj is not None):
            raise ValueError("pass an embedding iff the block was built with one")
        h = self.conv_in(self._resize(self.norm_in(x)))
        film = None
        if emb is not None:
            cond_a, cond_b = linear(gelu(emb), self.cond_proj).chunk(2, dim=-1)
            film = (cond_a, cond_b)
        h = self.conv_out(self.norm_mid(h, film))
        skip = self._resize(x)
        if self.skip_proj is not None:
            skip = self.skip_proj(skip)
        return skip + h
