"""WaveGrad-style predictor and encoder (counterpart of
``vq_voice_swap_tpu/models/wavegrad.py``): a stack of downsampling
``DBlock``s (x64 in all), and upsampling ``UBlock``s driven by the
conditioning sequence with three FiLM layers each (timestep + optional
label embedding + the matching down-path output -> (alpha, beta)),
LayerNorm over channels, and a zero-initialised output conv.

Activations are [N, C, T], as in the rest of the port. The JAX package
runs this family through XLA alone (no Pallas kernel), so it is plain
PyTorch here. Submodules carry the flax names by the checkpoint rule
(``convert/from_jax.py``): flax ``conv_1``, ``norm_3``, ``film_2`` and
``extra_norm_0`` are the entries ``conv.1``, ``norm.3``, ``film.2`` and
``extra_norm.0``; ``extra_conv_0_a`` keeps its name.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor import whole
from .layers import (Conv1d, Dropout, TimeEmbedding, avg_pool_1d, channels_first, embedding,
                     gelu, nearest_upsample_1d)

__all__ = ["ChannelLayerNorm", "FiLM", "UBlock", "DBlock", "WaveGradPredictor",
           "WaveGradEncoder"]


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of [N, C, T], eps 1e-5, with float32
    statistics and arithmetic whatever the input dtype (as flax computes
    them); output contiguous, in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float().transpose(1, 2), self.normalized_shape,
                         whole(self, "weight"), whole(self, "bias"), self.eps)
        return y.transpose(1, 2).to(x.dtype, memory_format=torch.contiguous_format)


class FiLM(nn.Module):
    """inputs * (1 + alpha) + beta, with (alpha, beta) from the timestep,
    the label (iff num_labels) and the conditioning sequence [N, Cz, T]."""

    def __init__(self, cond_channels: int, out_channels: int,
                 num_labels: Optional[int] = None):
        super().__init__()
        hidden = out_channels * 2
        self.time_emb = TimeEmbedding(hidden)
        if num_labels is not None:
            self.label_emb = nn.Embedding(num_labels, hidden)
        self.num_labels = num_labels
        self.cond_norm = ChannelLayerNorm(cond_channels)
        self.cond_conv = Conv1d(cond_channels, hidden, 3)
        self.out_conv = Conv1d(hidden, out_channels * 2, 3)

    def forward(self, inputs: torch.Tensor, cond: torch.Tensor, ts: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (labels is None) != (self.num_labels is None):
            raise ValueError("pass labels iff the FiLM was built with num_labels")
        emb = self.time_emb(ts, inputs.dtype)
        if labels is not None:
            emb = emb + embedding(labels, self.label_emb).to(inputs.dtype)
        emb = emb[:, :, None] + self.cond_conv(self.cond_norm(cond))
        alpha, beta = self.out_conv(gelu(emb)).chunk(2, dim=1)
        return inputs * (1.0 + alpha) + beta


class UBlock(nn.Module):
    """Upsampling block: h [N, Cin, T] -> [N, Cout, T * upsample_rate],
    with three FiLM stages conditioned on z [N, Cz, T * upsample_rate]."""

    def __init__(self, in_channels: int, cond_channels: int, out_channels: int,
                 upsample_rate: int, num_labels: Optional[int] = None):
        super().__init__()
        self.upsample_rate = upsample_rate
        self.res_conv = Conv1d(in_channels, out_channels, 3)
        self.norm = nn.ModuleDict({"1": ChannelLayerNorm(in_channels),
                                   "3": ChannelLayerNorm(out_channels)})
        self.conv = nn.ModuleDict({
            "1": Conv1d(in_channels, out_channels, 3),
            **{str(i): Conv1d(out_channels, out_channels, 3, dilation=d)
               for i, d in ((2, 2), (3, 4), (4, 8), (5, 16))},
        })
        self.film = nn.ModuleDict({str(i): FiLM(cond_channels, out_channels, num_labels)
                                   for i in (1, 2, 3)})

    def forward(self, h: torch.Tensor, z: torch.Tensor, ts: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv, film = self.conv, self.film
        res = self.res_conv(nearest_upsample_1d(h, self.upsample_rate))
        out = nearest_upsample_1d(gelu(self.norm["1"](h)), self.upsample_rate)
        out = film["1"](conv["1"](out), z, ts, labels)
        out = conv["2"](gelu(out)) + res

        res = out
        out = self.norm["3"](film["2"](out, z, ts, labels))
        out = film["3"](conv["3"](gelu(out)), z, ts, labels)
        out = conv["5"](gelu(conv["4"](gelu(out))))
        return out + res


class DBlock(nn.Module):
    """Downsampling block: h [N, Cin, T] -> [N, Cout, T / downsample_rate],
    with ``extra_blocks`` residual dilated stacks after it."""

    def __init__(self, in_channels: int, out_channels: int, downsample_rate: int,
                 extra_blocks: int = 0):
        super().__init__()
        self.downsample_rate = downsample_rate
        self.extra_blocks = extra_blocks
        self.res_conv = Conv1d(in_channels, out_channels, 3)
        self.norm_in = ChannelLayerNorm(in_channels)
        self.conv = nn.ModuleDict({"1": Conv1d(in_channels, out_channels, 3),
                                   "2": Conv1d(out_channels, out_channels, 3, dilation=2)})
        self.extra_norm = nn.ModuleList(ChannelLayerNorm(out_channels)
                                        for _ in range(extra_blocks))
        for i in range(extra_blocks):
            for tag, d in (("a", 1), ("b", 4), ("c", 8)):
                setattr(self, f"extra_conv_{i}_{tag}",
                        Conv1d(out_channels, out_channels, 3, dilation=d))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        rate = self.downsample_rate
        res = avg_pool_1d(self.res_conv(h), rate)
        out = avg_pool_1d(self.norm_in(h), rate)
        out = self.conv["2"](gelu(self.conv["1"](gelu(out)))) + res
        for i in range(self.extra_blocks):
            e = self.extra_norm[i](out)
            for tag in "abc":
                e = getattr(self, f"extra_conv_{i}_{tag}")(gelu(e))
            out = out + e
        return out


class WaveGradPredictor(nn.Module):
    """Epsilon predictor. x: [N, T, 1] with T a multiple of 64; ts: [N];
    cond: [N, T / 64, cond_mult * base_channels], or None for a zero
    sequence; labels (iff num_labels): [N] ints. Output [N, T, 1] float32.
    ``dtype`` is the compute dtype (None = float32)."""

    def __init__(self, base_channels: int = 32, cond_mult: int = 16,
                 num_labels: Optional[int] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        ch = base_channels
        self.cond_channels = cond_mult * ch
        self.num_labels = num_labels
        self.dtype = dtype
        self.d_in_conv = Conv1d(1, ch, 5)
        d_specs = [(4, 4), (4, 2), (8, 2), (16, 2)]
        d_chs = [ch] + [ch * m for m, _ in d_specs]
        self.d_block = nn.ModuleList(DBlock(d_chs[i], ch * m, rate)
                                     for i, (m, rate) in enumerate(d_specs))
        self.u_in_conv = Conv1d(self.cond_channels, ch * 24, 3)
        u_blocks, cur = [], ch * 24
        for mult, rate in [(16, 2), (16, 2), (8, 2), (4, 2), (4, 4)]:
            u_blocks.append(UBlock(cur, d_chs.pop(), ch * mult, rate, num_labels))
            cur = ch * mult
        self.u_block = nn.ModuleList(u_blocks)
        self.out_norm = ChannelLayerNorm(cur)
        self.out_conv = Conv1d(cur, 1, 3)

    @property
    def downsample_rate(self) -> int:
        return 64

    def forward(
        self,
        x: torch.Tensor,
        ts: torch.Tensor,
        cond: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        dropout: Optional[Dropout] = None,
    ) -> torch.Tensor:
        if dropout is not None:
            raise ValueError("the wavegrad predictor has no dropout")
        if x.shape[1] % 64:
            raise ValueError(f"input length {x.shape[1]} is not a multiple of 64")
        if (labels is None) != (self.num_labels is None):
            raise ValueError("pass labels iff the model is class-conditional")
        dtype = self.dtype or torch.float32
        h = self.d_in_conv(channels_first(x, dtype))
        if cond is None:
            u = torch.zeros((x.shape[0], self.cond_channels, x.shape[1] // 64),
                            dtype=dtype, device=x.device)
        else:
            u = channels_first(cond, dtype)
        d_outs = [h]
        for block in self.d_block:
            h = block(h)
            d_outs.append(h)
        u = self.u_in_conv(u)
        for block in self.u_block:
            u = block(u, d_outs.pop(), ts, labels)
        return self.out_conv(self.out_norm(u)).transpose(1, 2).float()


class WaveGradEncoder(nn.Module):
    """The WaveGrad down stack as a VQ-VAE encoder: [N, T, 1] ->
    [N, T / 64, cond_mult * base_channels] float32."""

    def __init__(self, base_channels: int = 32, cond_mult: int = 16,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ch = base_channels
        self.dtype = dtype
        self.in_conv = Conv1d(1, ch, 5)
        specs = [(ch * 4, 4), (ch * 4, 2), (ch * 8, 2), (ch * 16, 2), (ch * cond_mult, 2)]
        chs = [ch] + [c for c, _ in specs]
        self.d_block = nn.ModuleList(DBlock(chs[i], c, rate, extra_blocks=1)
                                     for i, (c, rate) in enumerate(specs))

    @property
    def downsample_rate(self) -> int:
        return 64

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(channels_first(x, self.dtype or torch.float32))
        for block in self.d_block:
            h = block(h)
        return h.transpose(1, 2).float()
