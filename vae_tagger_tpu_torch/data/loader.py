"""Bucket-aware batching and a threaded prefetching loader (the port's
copy of ``vae_tagger_tpu/data/loader.py``).

- ``BucketBatchSampler`` groups samples by aspect-ratio bucket (one group
  without bucketing), so every batch is one shape, and yields
  ``(indices, mask)`` in a shuffle order that is a pure function of (seed,
  epoch): a resumed run replays the order of the epoch it stopped in.  The
  last, partial batch of a group is filled up to ``batch_size`` from its
  own rows, in order, and the mask marks the repeats, which evaluation
  drops (``batch_mask``).
- ``DataLoader`` decodes on a thread pool (PIL releases the GIL) and keeps
  ``prefetch_factor`` collated numpy batches ahead of the device.
- Data parallelism: every process builds the same global batches from the
  same indices and seed and loads only its contiguous slice of each
  (``process_index`` of ``process_count``), so the processes agree on
  batch counts and shapes by construction.  Each batch carries
  ``global_real_count``, the real rows of the global batch, from the
  global mask, so every process weights its metrics alike.

The TPU's rounding of the batch up to a multiple of 8 rows (``pad_multiple``)
is a sublane rule of the v5e and is left out: a global batch here has
exactly ``batch_size`` rows.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class BucketBatchSampler:
    """Yields (indices, mask) of ``batch_size`` rows, all of one bucket."""

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
        self.bucket_groups: Dict[tuple, List[int]] = {}
        for i in self.indices:
            bucket = (dataset.bucket_of(i) if hasattr(dataset, "bucket_of")
                      else None)
            self.bucket_groups.setdefault(bucket or ("fixed",), []).append(i)

    def __len__(self) -> int:
        return sum(-(-len(g) // self.batch_size)
                   for g in self.bucket_groups.values())

    def set_epoch(self, epoch: int) -> None:
        """Pin this epoch's shuffle stream (deterministic, resumable)."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[Tuple[List[int], List[bool]]]:
        # int arithmetic: int hashing is stable across interpreter runs
        rng = random.Random(self._seed * 1_000_003 + self._epoch)
        batches = []
        for group in self.bucket_groups.values():
            order = list(group)
            if self.shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), self.batch_size):
                chunk = order[start:start + self.batch_size]
                real = len(chunk)
                mask = [True] * real
                # repeat the chunk's own rows: deterministic, and for an
                # exact multiple the batch mean equals the real rows' mean
                for fill in range(self.batch_size - real):
                    chunk.append(chunk[fill % real])
                    mask.append(False)
                batches.append((chunk, mask))
        if self.shuffle:
            rng.shuffle(batches)
        return iter(batches)


def _collate(items: List[dict], mask: List[bool]) -> Dict[str, np.ndarray]:
    batch = {key: np.stack([np.asarray(it[key]) for it in items])
             for key in items[0]}
    batch["batch_mask"] = np.asarray(mask, dtype=bool)
    return batch


class DataLoader:
    """Threaded prefetching loader yielding collated numpy batches;
    ``batch_size`` is the global batch, which ``process_count`` must
    divide."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, prefetch_factor: int = 2,
                 seed: Optional[int] = 0,
                 indices: Optional[Sequence[int]] = None,
                 process_index: int = 0, process_count: int = 1):
        if batch_size % max(1, process_count):
            raise ValueError(
                f"process_count {process_count} must divide the global "
                f"batch size {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = BucketBatchSampler(dataset, batch_size, shuffle,
                                          seed=seed, indices=indices)
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch_factor)
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self._skip_next = 0

    def __len__(self) -> int:
        return len(self.sampler)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def skip_next(self, n: int) -> None:
        """Drop the first ``n`` batches of the next iteration only (exact
        mid-epoch resume); skipped batches are never decoded."""
        self._skip_next = int(n)

    def _local_slice(self, indices, mask):
        """(local indices, local mask, global real count): this process's
        contiguous slice of a global batch; the count comes from the
        global mask, so every process agrees on the batch's weight."""
        n_real_global = sum(mask)
        if self.process_count == 1:
            return indices, mask, n_real_global
        per = len(indices) // self.process_count
        lo = self.process_index * per
        return indices[lo:lo + per], mask[lo:lo + per], n_real_global

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        batches = [self._local_slice(idx, mask)
                   for idx, mask in self.sampler][self._skip_next:]
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
                    for indices, mask, n_real_global in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__,
                                              indices))
                        batch = _collate(items, mask)
                        batch["global_real_count"] = np.int64(n_real_global)
                        if not put(batch):
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
