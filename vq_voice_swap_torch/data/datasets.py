"""The training datasets (counterpart of ``vq_voice_swap_tpu/data/datasets.py``):

- ``LibriSpeech``: a windowed view of a LibriSpeech-style directory,
  ``<speaker>/.../<utterance>.flac`` (or ``.wav``). The file index with
  each file's duration is kept in ``<directory>/index.json``; windows are
  4 s long every 0.2 s, with 0.05 s taken off each duration estimate;
  labels are the speakers in sorted order; a window past a file's end is
  zero-padded. Windows are read from the decoded-audio cache
  (``cache.py``) unless ``use_cache=False``.
- ``ToneDataset``, 3 sine "speakers", and ``ChirpDataset``, 8
  non-stationary chirp "speakers": 4 s items at 16 kHz, deterministic and
  diskless.

Item i of any of them is the same array in both packages.
"""

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np

from .audio_io import ChunkReader, encode_from_linear, lookup_audio_duration

__all__ = ["ChirpDataset", "LibriSpeech", "ToneDataset", "build_file_index",
           "DURATION_ESTIMATE_SLACK", "AUDIO_EXTENSIONS"]

DURATION_ESTIMATE_SLACK = 0.05
AUDIO_EXTENSIONS = (".flac", ".wav")


@dataclass
class WindowRef:
    label: int
    path: str
    offset: int


def build_file_index(data_dir: str) -> Dict[str, Union[Dict, float]]:
    """The recursive {name: duration, or the index of a subdirectory} map of
    the audio files under data_dir, in sorted order, hidden names left out."""
    result: Dict[str, Union[Dict, float]] = {}
    for item in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, item)
        if item.startswith("."):
            continue
        if item.lower().endswith(AUDIO_EXTENSIONS):
            result[item] = lookup_audio_duration(path)
        elif os.path.isdir(path):
            sub = build_file_index(path)
            if sub:
                result[item] = sub
    return result


class LibriSpeech:
    """Windows of a LibriSpeech-style speaker directory tree."""

    def __init__(
        self,
        directory: str,
        encoding: str = "linear",
        window_duration: float = 4.0,
        window_spacing: float = 0.2,
        sample_rate: int = 16000,
        use_cache: bool = True,
        cache_dir: Optional[str] = None,
    ):
        self.directory = directory
        self.encoding = encoding
        self.window_duration = window_duration
        self.window_spacing = window_spacing
        self.sample_rate = sample_rate

        index_path = os.path.join(directory, "index.json")
        if os.path.exists(index_path):
            with open(index_path, "rt") as f:
                self.index = json.load(f)
        else:
            self.index = build_file_index(directory)
            # Written to a temporary name and renamed, so that a concurrent
            # builder never reads half an index.
            tmp = f"{index_path}.{os.getpid()}.tmp"
            with open(tmp, "wt") as f:
                json.dump(self.index, f)
            os.replace(tmp, index_path)

        self.speaker_ids = sorted(self.index.keys())
        self.windows: List[WindowRef] = []
        for label, speaker in enumerate(self.speaker_ids):
            self._index_speaker(label, os.path.join(directory, speaker), self.index[speaker])

        self.cache = None
        if use_cache:
            from .cache import WindowCache

            # Hosts that share a filesystem need a cache_dir each
            # (create_data_loader derives one from shard_index): the build
            # lock serialises the builders of one host only.
            self.cache = WindowCache(cache_dir or os.path.join(directory, ".window_cache"),
                                     sample_rate)
            self.cache.build(sorted({w.path for w in self.windows}))

    def _index_speaker(self, label: int, path: str, entry) -> None:
        for name, item in entry.items():
            sub_path = os.path.join(path, name)
            if isinstance(item, dict):
                self._index_speaker(label, sub_path, item)
                continue
            window = int(self.sample_rate * self.window_duration)
            spacing = int(self.sample_rate * self.window_spacing)
            total = int(self.sample_rate * (item - DURATION_ESTIMATE_SLACK))
            if window >= total:
                self.windows.append(WindowRef(label, sub_path, 0))
            else:
                offset = 0
                while offset + window < total:
                    self.windows.append(WindowRef(label, sub_path, offset))
                    offset += spacing

    def __len__(self) -> int:
        return len(self.windows)

    def get_batch(self, indices) -> Dict[str, np.ndarray]:
        """A batch of windows from the cache in one gather (the loader's
        fast path)."""
        num_samples = int(self.sample_rate * self.window_duration)
        refs = [self.windows[int(i)] for i in indices]
        samples = self.cache.read_windows([(r.path, r.offset) for r in refs], num_samples)
        samples = encode_from_linear(samples, self.encoding)
        labels = np.asarray([r.label for r in refs], np.int32)
        return {"label": labels, "samples": samples.astype(np.float32)}

    def __getitem__(self, index: int) -> Dict[str, Union[int, np.ndarray]]:
        ref = self.windows[index]
        num_samples = int(self.sample_rate * self.window_duration)
        if self.cache is not None:
            samples = self.cache.read_window(ref.path, ref.offset, num_samples)
            samples = encode_from_linear(samples, self.encoding)
        else:
            with ChunkReader(ref.path, self.sample_rate, encoding=self.encoding) as reader:
                if ref.offset:
                    reader.read(ref.offset)  # seek by discarding
                samples = reader.read(num_samples)
            if samples is None:
                samples = np.zeros(0, dtype=np.float32)
            if len(samples) < num_samples:
                samples = np.pad(samples, (0, num_samples - len(samples)))
        return {"label": ref.label, "samples": samples.astype(np.float32)}


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
