"""Content-only conv encoder over MFCC features (counterpart of
``vq_voice_swap_tpu/models/mfcc_encoder.py``).

Optional µ-law inversion, MFCC + delta + delta-delta (39 channels), a conv
stack with one stride-2 downsample, and a 1x1 output conv. Submodule names
follow the flax ones by the checkpoint rule: flax ``res_0`` is ``res.0``,
``res_3_<i>`` is ``res_3.<i>``, ``res_1_<i>`` is ``res_1.<i>``.
"""

from typing import Optional

import torch
from torch import nn

from ..ops.mfcc import MFCCConfig, mfcc
from .layers import Conv1d, channels_first, conv1d, gelu

__all__ = ["ConvMFCCEncoder", "deltas", "invert_ulaw"]


def deltas(seq: torch.Tensor) -> torch.Tensor:
    """Symmetric first difference over the T axis of [N, T, C] with edge
    replication."""
    right = torch.cat([seq[:, :1], seq[:, :-1]], dim=1)
    left = torch.cat([seq[:, 1:], seq[:, -1:]], dim=1)
    return (right - left) / 2.0


def invert_ulaw(x: torch.Tensor, mu: float = 255.0) -> torch.Tensor:
    return torch.sign(x) * (1.0 / mu) * ((1.0 + mu) ** torch.abs(x) - 1.0)


class ConvMFCCEncoder(nn.Module):
    """MFCC conv encoder; input [N, T, 1] -> [N, T1, out_channels] float32.

    version 1: n_fft = 2 * input_rate / mfcc_rate, 40 mels, log-mels.
    version 2: n_fft = 400 * input_rate / 16000, 80 mels, dB scale,
               normalized spectrogram.
    """

    def __init__(
        self,
        base_channels: int,
        out_channels: int = 64,
        input_ulaw: bool = True,
        input_rate: int = 16000,
        mfcc_rate: int = 100,
        version: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if mfcc_rate % 2 or input_rate % mfcc_rate:
            raise ValueError("mfcc_rate must be even and divide input_rate")
        self.input_ulaw = input_ulaw
        self.input_rate = input_rate
        self.mfcc_rate = mfcc_rate
        self.dtype = dtype
        n_fft = (
            round(400 * input_rate / 16000) if version == 2
            else (input_rate // mfcc_rate) * 2
        )
        self.mfcc_config = MFCCConfig(
            sample_rate=input_rate,
            n_mfcc=13,
            n_fft=n_fft,
            hop_length=input_rate // mfcc_rate,
            n_mels=40 if version == 1 else 80,
            log_mels=version == 1,
            normalized=version == 2,
        )
        mid = base_channels * 12
        self.conv_in = Conv1d(39, mid, 3)
        self.res = nn.ModuleList([Conv1d(mid, mid, 3)])
        self.down_conv = nn.Conv1d(mid, mid, 4, stride=2, padding=1)
        self.res_3 = nn.ModuleList(Conv1d(mid, mid, 3) for _ in range(2))
        self.res_1 = nn.ModuleList(Conv1d(mid, mid, 1) for _ in range(4))
        self.out_conv = Conv1d(mid, out_channels, 1)

    @property
    def downsample_rate(self) -> int:
        return self.input_rate // (self.mfcc_rate // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != 1:
            raise ValueError("input must have one channel")
        wav = x[..., 0]
        if self.input_ulaw:
            wav = invert_ulaw(wav)
        h = mfcc(wav, self.mfcc_config)
        d1 = deltas(h)
        h = torch.cat([h, d1, deltas(d1)], dim=-1)  # [N, frames, 39]
        h = channels_first(h, self.dtype or torch.float32)

        h = gelu(self.conv_in(h))
        h = h + gelu(self.res[0](h))
        h = gelu(conv1d(h, self.down_conv))
        for conv in (*self.res_3, *self.res_1):
            h = h + gelu(conv(h))
        return self.out_conv(h).transpose(1, 2).float()
