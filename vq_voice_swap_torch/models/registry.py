"""Name-based model factories (counterpart of
``vq_voice_swap_tpu/models/registry.py``): predictors "unet" | "wavegrad";
encoders "unet" | "unet128" | "unet128-dilated" | "wavegrad" |
"conv-mfcc-ulaw" | "conv-mfcc-ulaw-v2" | "conv-mfcc-linear".

``remat`` reaches the UNet predictor and the UNet encoders, as in the JAX
package; the WaveGrad and MFCC modules take no remat and ignore it.
``act_int8_min_t`` (int8 activation storage, ``ops/qact.py``) is a UNet
option: the WaveGrad and MFCC modules refuse it."""

from typing import Optional, Union

import torch
from torch import nn

from .mfcc_encoder import ConvMFCCEncoder
from .unet import UNetEncoder, UNetPredictor
from .wavegrad import WaveGradEncoder, WaveGradPredictor

__all__ = ["make_predictor", "make_encoder"]


def make_predictor(
    pred_name: str,
    base_channels: int = 32,
    num_labels: Optional[int] = None,
    cond_channels: Optional[int] = None,
    dropout: float = 0.0,
    dtype: Optional[torch.dtype] = None,
    fuse_levels: int = 0,
    remat: Union[bool, str, None] = None,
    act_int8_min_t: int = 0,
) -> nn.Module:
    """Create an epsilon-predictor module from a human-readable name;
    ``fuse_levels`` and ``act_int8_min_t`` are UNetPredictor's serving
    options. ``dropout`` is run by the caller
    (``DiffusionModel.predict_eps``); wavegrad has none."""
    if pred_name == "unet":
        return UNetPredictor(
            base_channels=base_channels,
            cond_channels=cond_channels,
            num_labels=num_labels,
            dtype=dtype,
            fuse_levels=fuse_levels,
            remat=remat,
            act_int8_min_t=act_int8_min_t,
        )
    if pred_name == "wavegrad":
        if dropout:
            raise ValueError("dropout is not supported for wavegrad")
        if act_int8_min_t:
            raise ValueError("int8 activation storage is implemented for the unet "
                             "predictor only")
        if fuse_levels:
            raise ValueError("fuse_levels is a unet option; wavegrad has no fused blocks")
        if cond_channels and cond_channels % base_channels:
            raise ValueError(f"wavegrad cond_channels ({cond_channels}) must be a multiple "
                             f"of base_channels ({base_channels})")
        return WaveGradPredictor(
            base_channels=base_channels,
            cond_mult=cond_channels // base_channels if cond_channels else 16,
            num_labels=num_labels,
            dtype=dtype,
        )
    raise ValueError(f"unknown predictor: {pred_name}")


def make_encoder(
    enc_name: str,
    base_channels: int = 32,
    cond_mult: int = 16,
    dtype: Optional[torch.dtype] = None,
    remat: Union[bool, str, None] = None,
    act_int8_min_t: int = 0,
) -> nn.Module:
    """Create an encoder module from a human-readable name."""
    out_channels = base_channels * cond_mult
    if act_int8_min_t and not enc_name.startswith("unet"):
        raise ValueError("int8 activation storage is implemented for the unet encoders only")
    if enc_name == "unet":
        return UNetEncoder(
            base_channels=base_channels, out_channels=out_channels, dtype=dtype,
            remat=remat, act_int8_min_t=act_int8_min_t,
        )
    if enc_name in ("unet128", "unet128-dilated"):
        return UNetEncoder(
            base_channels=base_channels,
            channel_mult=(1, 1, 2, 2, 2, 4, 4, 8),
            out_dilations=(4, 8, 16, 32) if enc_name == "unet128-dilated" else (),
            out_channels=out_channels,
            dtype=dtype,
            remat=remat,
            act_int8_min_t=act_int8_min_t,
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
        return WaveGradEncoder(base_channels=base_channels, cond_mult=cond_mult, dtype=dtype)
    raise ValueError(f"unknown encoder: {enc_name}")
