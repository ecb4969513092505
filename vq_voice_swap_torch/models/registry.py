"""Name-based model factories (counterpart of
``vq_voice_swap_tpu/models/registry.py``). The ``wavegrad`` predictor and
encoder are not ported yet."""

from typing import Optional

import torch
from torch import nn

from .mfcc_encoder import ConvMFCCEncoder
from .unet import UNetEncoder, UNetPredictor

__all__ = ["make_predictor", "make_encoder"]

_WAVEGRAD = "wavegrad is not ported yet; a later slice of the port adds it"


def make_predictor(
    pred_name: str,
    base_channels: int = 32,
    num_labels: Optional[int] = None,
    cond_channels: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    fuse_levels: int = 0,
) -> nn.Module:
    """Create an epsilon-predictor module from a human-readable name;
    ``fuse_levels`` is UNetPredictor's serving option."""
    if pred_name == "unet":
        return UNetPredictor(
            base_channels=base_channels,
            cond_channels=cond_channels,
            num_labels=num_labels,
            dtype=dtype,
            fuse_levels=fuse_levels,
        )
    if pred_name == "wavegrad":
        raise NotImplementedError(_WAVEGRAD)
    raise ValueError(f"unknown predictor: {pred_name}")


def make_encoder(
    enc_name: str,
    base_channels: int = 32,
    cond_mult: int = 16,
    dtype: Optional[torch.dtype] = None,
) -> nn.Module:
    """Create an encoder module from a human-readable name."""
    out_channels = base_channels * cond_mult
    if enc_name == "unet":
        return UNetEncoder(
            base_channels=base_channels, out_channels=out_channels, dtype=dtype
        )
    if enc_name in ("unet128", "unet128-dilated"):
        return UNetEncoder(
            base_channels=base_channels,
            channel_mult=(1, 1, 2, 2, 2, 4, 4, 8),
            out_dilations=(4, 8, 16, 32) if enc_name == "unet128-dilated" else (),
            out_channels=out_channels,
            dtype=dtype,
        )
    if enc_name == "conv-mfcc-ulaw":
        return ConvMFCCEncoder(
            base_channels=base_channels, out_channels=out_channels, dtype=dtype
        )
    if enc_name == "conv-mfcc-ulaw-v2":
        return ConvMFCCEncoder(
            base_channels=base_channels, out_channels=out_channels, version=2,
            dtype=dtype,
        )
    if enc_name == "conv-mfcc-linear":
        return ConvMFCCEncoder(
            base_channels=base_channels, out_channels=out_channels,
            input_ulaw=False, dtype=dtype,
        )
    if enc_name == "wavegrad":
        raise NotImplementedError(_WAVEGRAD)
    raise ValueError(f"unknown encoder: {enc_name}")
