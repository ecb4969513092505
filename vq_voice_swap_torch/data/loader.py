"""Shuffled batches with background prefetch (counterpart of
``vq_voice_swap_tpu/data/loader.py``): epoch e is the permutation of
``np.random.RandomState(seed + e)``, cut into full batches (the last
partial one dropped), so both packages see the same batches in the same
order. With ``num_shards`` > 1, every shard takes the same permutation and
its own strided slice of it. Batches are numpy dicts {"label": [N] int32,
"samples": [N, T] float32}, collated by a thread pool ahead of the
consumer; a dataset with a window cache gives a whole batch in one gather
(``get_batch``)."""

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Tuple

import numpy as np

from ..observe import span
from .datasets import ChirpDataset, LibriSpeech, ToneDataset

__all__ = ["DataLoader", "create_data_loader"]


class DataLoader:
    """Shuffled, drop-last batch iterator with prefetching."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, prefetch: int = 4,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1):
        """Every shard gets ``len(dataset) // num_shards`` items an epoch,
        disjoint from the other shards', so hosts stay in step."""
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._epoch = 0
        self._seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards

    def __len__(self) -> int:
        return len(self.dataset) // self.num_shards // self.batch_size

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        np.random.RandomState((self._seed + self._epoch) % 2**31).shuffle(order)
        self._epoch += 1
        if self.num_shards > 1:
            usable = len(order) - len(order) % self.num_shards
            order = order[self.shard_index:usable:self.num_shards]
        end = len(order) - len(order) % self.batch_size
        for i in range(0, end, self.batch_size):
            yield order[i:i + self.batch_size]

    def _collate(self, idxs) -> Dict[str, np.ndarray]:
        if getattr(self.dataset, "cache", None) is not None:
            return self.dataset.get_batch(idxs)
        items = [self.dataset[int(i)] for i in idxs]
        return {
            "label": np.asarray([it["label"] for it in items], np.int32),
            "samples": np.stack([it["samples"] for it in items]).astype(np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if len(self) == 0:
            raise ValueError(
                f"batch_size {self.batch_size} larger than the dataset "
                f"({len(self.dataset)} items): no batch would ever be produced"
            )
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()  # set when the consumer abandons iteration

        def put(item) -> bool:
            """A put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # At most workers + prefetch batches in flight.
            window = self.num_workers + self.prefetch
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = deque()
                    for idxs in self._batch_indices():
                        if stop.is_set():
                            break
                        pending.append(pool.submit(self._collate, idxs))
                        if len(pending) >= window and not put(pending.popleft().result()):
                            break
                    while pending and not stop.is_set():
                        if not put(pending.popleft().result()):
                            break
                    for fut in pending:
                        fut.cancel()
            except BaseException as exc:  # re-raised in the consumer
                put(exc)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with span("vvs.data.wait"):
                    item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while True:  # drain, so that a blocked put wakes at once
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=10)


def create_data_loader(directory: str, batch_size: int, encoding: str = "linear",
                       num_workers: int = 4, seed: int = 0, shard_index: int = 0,
                       num_shards: int = 1, **dataset_kwargs) -> Tuple[DataLoader, int]:
    """(loader, num_labels) for "tones" (3 speakers x 10 phases), "tones:N"
    (N phases), "chirps" (8 speakers x 10 items), "chirps:N", or else a
    LibriSpeech-style directory (``dataset_kwargs`` go to ``LibriSpeech``).
    ``shard_index``/``num_shards`` give each host a disjoint slice of every
    epoch's shared permutation (see ``DataLoader``)."""
    name, _, count = directory.partition(":")
    if name == "tones":
        dataset = ToneDataset(encoding=encoding, phases=int(count or 10))
    elif name == "chirps":
        dataset = ChirpDataset(encoding=encoding, items_per_speaker=int(count or 10))
    else:
        if num_shards > 1:
            # A window cache for each host: the data directory is usually
            # on a shared filesystem, where the cache's build lock holds
            # within one host only.
            dataset_kwargs.setdefault(
                "cache_dir", os.path.join(directory, f".window_cache_h{shard_index}"))
        dataset = LibriSpeech(directory, encoding=encoding, **dataset_kwargs)
    loader = DataLoader(dataset, batch_size=batch_size, num_workers=num_workers, seed=seed,
                        shard_index=shard_index, num_shards=num_shards)
    return loader, len(dataset.speaker_ids)
