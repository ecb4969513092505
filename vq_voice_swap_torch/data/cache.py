"""The decoded-audio window cache (counterpart of
``vq_voice_swap_tpu/data/cache.py``): each file is decoded once into a raw
float32 arena on disk, so that a window read is a slice of a memory map
and not a decoder run.

Layout, the same as the JAX package's, so a cache built by either package
reads in the other: ``<cache_dir>/arena.f32`` (mono float32 at the sample
rate, the files one after another) and ``<cache_dir>/arena_index.json``
({"sample_rate": rate, "files": {path: [offset, length]}}).
"""

import fcntl
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .audio_io import ChunkReader
from .native import batch_gather_windows

__all__ = ["WindowCache"]

_CHUNK = 1 << 18  # samples per read while building
_INDEX_EVERY = 200  # files between index checkpoints while building


class WindowCache:
    def __init__(self, cache_dir: str, sample_rate: int = 16000):
        self.cache_dir = cache_dir
        self.sample_rate = sample_rate
        os.makedirs(cache_dir, exist_ok=True)
        self.arena_path = os.path.join(cache_dir, "arena.f32")
        self.index_path = os.path.join(cache_dir, "arena_index.json")
        self.index: Dict[str, Tuple[int, int]] = {}
        self._mmap: Optional[np.memmap] = None
        self._load_index()

    def _load_index(self) -> None:
        if not os.path.exists(self.index_path):
            return
        with open(self.index_path, "rt") as f:
            meta = json.load(f)
        if meta["sample_rate"] != self.sample_rate:
            raise ValueError(f"{self.index_path} was built at {meta['sample_rate']} Hz, "
                             f"not {self.sample_rate}")
        self.index = {k: tuple(v) for k, v in meta["files"].items()}

    # ------------------------------------------------------------- building

    def build(self, paths) -> None:
        """Decode the files not yet cached and append them to the arena.

        Builders on one host (several loader processes) take an exclusive
        flock around the appends: two interleaved appends would scatter
        each other's samples through both index spans. flock is not
        enforced across hosts on every network filesystem, so hosts that
        share a filesystem each need a cache_dir of their own."""
        missing = [p for p in paths if p not in self.index]
        if not missing:
            return
        with open(os.path.join(self.cache_dir, ".build_lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                # Another builder may have appended while this one waited:
                # re-read the index, and reopen the memory map in any case,
                # since a map of the shorter arena would read zeros past
                # its old end.
                self._mmap = None
                self._load_index()
                missing = [p for p in paths if p not in self.index]
                if not missing:
                    return
                # Append at the end of the index, not of the file: a builder
                # killed mid-write leaves bytes no span covers (perhaps not
                # a multiple of 4, which np.memmap refuses). Truncate them;
                # their file was never indexed, so it is decoded again.
                offset = max((off + ln for off, ln in self.index.values()), default=0)
                if (os.path.exists(self.arena_path)
                        and os.path.getsize(self.arena_path) != offset * 4):
                    with open(self.arena_path, "rb+") as f:
                        f.truncate(offset * 4)
                # Save the index every _INDEX_EVERY files, so that an
                # interrupted build of a large directory loses little.
                with open(self.arena_path, "ab") as arena:
                    for done, path in enumerate(missing, 1):
                        length = 0
                        with ChunkReader(path, self.sample_rate) as reader:
                            while True:
                                chunk = reader.read(_CHUNK)
                                if chunk is None or len(chunk) == 0:
                                    break
                                arena.write(np.asarray(chunk, dtype="<f4").tobytes())
                                length += len(chunk)
                        self.index[path] = (offset, length)
                        offset += length
                        if done % _INDEX_EVERY == 0:
                            arena.flush()
                            self._write_index()
                self._write_index()
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def _write_index(self) -> None:
        tmp = self.index_path + ".tmp"
        with open(tmp, "wt") as f:
            json.dump({"sample_rate": self.sample_rate,
                       "files": {k: list(v) for k, v in self.index.items()}}, f)
        os.replace(tmp, self.index_path)

    # -------------------------------------------------------------- reading

    def _arena(self) -> np.memmap:
        if self._mmap is None:
            self._mmap = np.memmap(self.arena_path, dtype="<f4", mode="r")
        return self._mmap

    def file_length(self, path: str) -> int:
        return self.index[path][1]

    def read_window(self, path: str, offset: int, num_samples: int) -> np.ndarray:
        """A float32 window of a cached file, zero-padded past its end."""
        base, length = self.index[path]
        start = base + min(offset, length)
        end = base + min(offset + num_samples, length)
        window = np.asarray(self._arena()[start:end], dtype=np.float32)
        if len(window) < num_samples:
            window = np.pad(window, (0, num_samples - len(window)))
        return window

    def _spans(self, refs):
        starts = np.empty(len(refs), np.int64)
        avail = np.empty(len(refs), np.int64)
        for i, (path, offset) in enumerate(refs):
            base, length = self.index[path]
            offset = min(offset, length)
            starts[i] = base + offset
            avail[i] = length - offset
        return starts, avail

    def read_windows(self, refs, num_samples: int, gather=batch_gather_windows) -> np.ndarray:
        """[N, num_samples] windows for refs, a list of (path, offset), in
        one call of ``gather`` (the C gather; the tests pass its plain
        version)."""
        return gather(self._arena(), *self._spans(refs), num_samples)
