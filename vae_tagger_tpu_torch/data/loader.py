"""Batching and a threaded prefetching loader (the port's copy of
``vae_tagger_tpu/data/loader.py`` for one process and square images).

- ``BucketBatchSampler`` yields fixed-size index lists in a shuffle order
  that is a pure function of (seed, epoch), so a resumed run replays the
  order of the epoch it stopped in.  Without bucketing every sample shares
  one shape, so it is a plain batch sampler; the last batch may be short.
- ``DataLoader`` decodes on a thread pool (PIL releases the GIL) and keeps
  ``prefetch_factor`` collated numpy batches ahead of the device.

The TPU's padding of batches to 8 rows and the per-process slicing of the
multi-host loader are not carried over.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class BucketBatchSampler:
    """Yields lists of dataset indices, ``batch_size`` at most."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: Optional[int] = 0,
                 indices: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._seed = 0 if seed is None else int(seed)
        self._epoch = 0
        self.indices = (list(indices) if indices is not None
                        else list(range(len(dataset))))

    def __len__(self) -> int:
        return -(-len(self.indices) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin this epoch's shuffle stream (deterministic, resumable)."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[List[int]]:
        # int arithmetic: int hashing is stable across interpreter runs
        rng = random.Random(self._seed * 1_000_003 + self._epoch)
        order = list(self.indices)
        if self.shuffle:
            rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.shuffle:
            rng.shuffle(batches)
        return iter(batches)


def _collate(items: List[dict]) -> Dict[str, np.ndarray]:
    return {key: np.stack([np.asarray(it[key]) for it in items])
            for key in items[0]}


class DataLoader:
    """Threaded prefetching loader yielding collated numpy batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, prefetch_factor: int = 2,
                 seed: Optional[int] = 0,
                 indices: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = BucketBatchSampler(dataset, batch_size, shuffle,
                                          seed=seed, indices=indices)
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch_factor)
        self._skip_next = 0

    def __len__(self) -> int:
        return len(self.sampler)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def skip_next(self, n: int) -> None:
        """Drop the first ``n`` batches of the next iteration only (exact
        mid-epoch resume); skipped batches are never decoded."""
        self._skip_next = int(n)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        batches = list(self.sampler)[self._skip_next:]
        self._skip_next = 0
        stop = threading.Event()

        def put(item) -> bool:
            # never block forever: the consumer may have stopped early
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for indices in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__,
                                              indices))
                        if not put(_collate(items)):
                            return
                put(None)
            except BaseException as e:  # surface in the consumer, not hang
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)


def train_val_split(n: int, val_fraction: float = 0.1,
                    seed: int = 42) -> tuple:
    """Random split with at least one validation sample."""
    indices = list(range(n))
    random.Random(seed).shuffle(indices)
    val_size = max(1, int(n * val_fraction))
    return indices[val_size:], indices[:val_size]
