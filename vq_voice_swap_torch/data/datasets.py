"""The synthetic training datasets (counterpart of the fixtures of
``vq_voice_swap_tpu/data/datasets.py``): ``ToneDataset``, 3 sine
"speakers", and ``ChirpDataset``, 8 non-stationary chirp "speakers", each
item 4 s at 16 kHz, deterministic and diskless. Item i of either is the
same array in both packages. LibriSpeech-style directories come with the
real-audio slice of the port."""

from typing import Dict, Union

import numpy as np

from .audio_io import encode_from_linear

__all__ = ["ChirpDataset", "ToneDataset"]


class ToneDataset:
    """Each "speaker" is a sine frequency, each item a phase shift."""

    def __init__(self, encoding: str = "linear", sample_rate: int = 16000,
                 num_samples: int = 64000, phases: int = 10):
        self.encoding = encoding
        self.sample_rate = sample_rate
        self.num_samples = num_samples
        self.phases = phases
        self.speaker_ids = [300, 500, 1000]

    def __len__(self) -> int:
        return len(self.speaker_ids) * self.phases

    def __getitem__(self, index: int) -> Dict[str, Union[int, np.ndarray]]:
        speaker = index % len(self.speaker_ids)
        freq = self.speaker_ids[speaker]
        phase = (index // len(self.speaker_ids)) / self.phases
        t = np.arange(self.num_samples, dtype=np.float32) / self.sample_rate
        samples = np.sin((t + phase) * (2 * np.pi * freq)).astype(np.float32)
        return {"label": speaker, "samples": encode_from_linear(samples, self.encoding)}


class ChirpDataset:
    """8 "speakers", each an FM chirp (a speaker-specific carrier and sweep
    depth) with a second harmonic, amplitude tremolo and Hann-windowed
    noise bursts, |x| <= ~0.6. The speaker fixes the timbre; the item index
    seeds the phases, the sweep direction and the bursts."""

    def __init__(self, encoding: str = "linear", sample_rate: int = 16000,
                 num_samples: int = 64000, items_per_speaker: int = 10):
        self.encoding = encoding
        self.sample_rate = sample_rate
        self.num_samples = num_samples
        self.items_per_speaker = items_per_speaker
        self.speaker_ids = list(range(8))

    def __len__(self) -> int:
        return len(self.speaker_ids) * self.items_per_speaker

    def __getitem__(self, index: int) -> Dict[str, Union[int, np.ndarray]]:
        n_spk = len(self.speaker_ids)
        speaker = index % n_spk
        item = index // n_spk
        rng = np.random.RandomState(speaker * 100003 + item)
        sr = self.sample_rate
        n = self.num_samples
        t = np.arange(n, dtype=np.float64) / sr
        dur = n / sr

        f0 = 180.0 * (1.32 ** speaker)
        fm_depth = 0.20 + 0.05 * speaker
        am_rate = 1.5 + 0.9 * speaker
        am_depth = 0.20 + 0.05 * speaker
        h2 = 0.12 + 0.04 * speaker
        bursts_per_sec = 0.5 + 0.5 * (speaker % 4)

        phase0 = rng.uniform(0.0, 1.0)
        sweep = 1.0 if item % 2 == 0 else -1.0
        inst_freq = f0 * (1.0 + fm_depth * sweep * (t / dur - 0.5))
        ph = 2 * np.pi * (np.cumsum(inst_freq) / sr + phase0)
        wave = np.sin(ph) + h2 * np.sin(2.0 * ph + 1.3)
        trem = np.sin(2 * np.pi * am_rate * t + 2 * np.pi * rng.uniform())
        wave *= 1.0 - am_depth * 0.5 * (1.0 + trem)

        for _ in range(rng.poisson(bursts_per_sec * dur)):
            c = rng.randint(0, n)
            w = rng.randint(sr // 33, sr // 12)
            lo, hi = max(0, c - w), min(n, c + w)
            wave[lo:hi] += 0.4 * np.hanning(hi - lo) * rng.randn(hi - lo)

        wave *= 0.6 / max(1.0, np.abs(wave).max() / 0.999)
        samples = encode_from_linear(np.asarray(wave, dtype=np.float32), self.encoding)
        return {"label": speaker, "samples": samples}
