"""MFCC frontend in PyTorch, with torchaudio's default semantics.

center=True reflect-pad framing, a periodic Hann window, a float32 rfft
power spectrogram, an HTK mel filterbank (f_min 0, f_max sr/2, no norm),
log (v1) or amplitude-to-dB (v2) compression, and an orthonormal DCT-II.
The numpy constants are copied from ``vq_voice_swap_tpu/ops/mfcc.py``.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["MFCCConfig", "mfcc", "mel_filterbank", "dct_matrix"]


def _hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int, n_mels: int, sample_rate: int,
    f_min: float = 0.0, f_max: Optional[float] = None,
) -> np.ndarray:
    """[n_freqs, n_mels] triangular HTK mel filterbank (no normalisation)."""
    f_max = f_max or sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(np.asarray(f_min)),
                        _hz_to_mel_htk(np.asarray(f_max)), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """[n_mels, n_mfcc] DCT-II matrix with 'ortho' normalisation."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    dct *= np.sqrt(2.0 / n_mels)
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    return dct.astype(np.float32)


class MFCCConfig:
    """Precomputed constants for an MFCC transform (host-side numpy)."""

    def __init__(
        self,
        sample_rate: int = 16000,
        n_mfcc: int = 13,
        n_fft: int = 320,
        hop_length: int = 160,
        n_mels: int = 40,
        log_mels: bool = True,
        normalized: bool = False,
        top_db: float = 80.0,
    ):
        self.sample_rate = sample_rate
        self.n_mfcc = n_mfcc
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.log_mels = log_mels
        self.normalized = normalized
        self.top_db = top_db
        self.window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
        self.fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate)
        self.dct = dct_matrix(n_mfcc, n_mels)


def mfcc(x: torch.Tensor, cfg: MFCCConfig) -> torch.Tensor:
    """MFCCs of a [N, T] waveform -> [N, frames, n_mfcc] float32."""
    x = x.float()
    pad = cfg.n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)  # [N, frames, n_fft]
    window = torch.as_tensor(cfg.window, device=x.device)
    spec = torch.abs(torch.fft.rfft(frames * window, dim=-1)) ** 2
    if cfg.normalized:
        spec = spec / float(np.sum(cfg.window**2))
    mel = spec @ torch.as_tensor(cfg.fb, device=x.device)
    if cfg.log_mels:
        feats = torch.log(mel + 1e-6)
    else:
        db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
        # torchaudio folds the batch into "channels" for MFCC's 3-D input,
        # so the top_db floor is ONE max over the whole batch, not per item.
        feats = torch.maximum(db, db.max() - cfg.top_db)
    return feats @ torch.as_tensor(cfg.dct, device=x.device)
