"""Overlapped decode -> device pipeline for directory inference (the port's
copy of ``vae_tagger_tpu/infer/pipeline.py``).

A producer thread decodes and resizes on a thread pool (PIL releases the GIL
while it decodes) and stages up to ``prefetch_factor`` collated uint8
batches in a bounded queue, so the host decodes batch N+1 while the device
runs batch N.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from typing import Iterator, Sequence

import numpy as np

from ..data.bucketing import (
    load_and_transform_image,
    load_and_transform_image_yuv,
)


def pad_tail_rows(block, rows: int):
    """Pad a tail batch up to ``rows`` by repeating the last row (the
    caller slices the results of pad rows off), so every batch has the
    same shape.  ``block`` is an array or a tuple of arrays with one
    leading batch dimension (the YUV planes)."""
    if isinstance(block, tuple):
        return tuple(pad_tail_rows(b, rows) for b in block)
    n = block.shape[0]
    if n >= rows:
        return block
    return np.concatenate(
        [block, np.repeat(block[-1:], rows - n, axis=0)], axis=0)


def iter_image_batches(image_paths: Sequence, resolution: int,
                       batch_size: int, num_workers: int = 4,
                       prefetch_factor: int = 2,
                       pixel_format: str = "rgb") -> Iterator[tuple]:
    """Decode images on a thread pool, yielding batches a queue ahead.

    Yields, in input order:
      ("batch", [paths], (n, H, W, 3) uint8)  with 1 <= n <= batch_size
      ("error", path, exception)              for undecodable images
    With ``pixel_format="yuv420"`` a batch's payload is the planar pair
    ((n, H, W) luma, (n, 2, H/2, W/2) chroma) instead.  Failed decodes
    never take a batch slot: every batch but the last is full.
    """
    if pixel_format not in ("rgb", "yuv420"):
        raise ValueError(f"unknown pixel_format {pixel_format!r}")
    yuv = pixel_format == "yuv420"
    out_q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch_factor))
    stop = threading.Event()

    def load(p):
        try:
            if yuv:
                return p, load_and_transform_image_yuv(str(p),
                                                       resolution), None
            return p, load_and_transform_image(str(p), resolution), None
        except Exception as e:  # reported to the consumer as an event
            return p, None, e

    def stack(items):
        if yuv:
            return (np.stack([t[0] for t in items]),
                    np.stack([t[1] for t in items]))
        return np.stack(items)

    def safe_put(item) -> bool:
        # never block forever: the consumer may have exited early
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            imgs, paths = [], []
            it = iter(image_paths)
            # a sliding window of decode futures consumed in input order:
            # one slow decode never idles the other workers
            inflight = deque()
            window = max(1, num_workers) + batch_size
            with ThreadPoolExecutor(max(1, num_workers)) as pool:
                def top_up():
                    while len(inflight) < window:
                        nxt = list(islice(it, 1))
                        if not nxt:
                            return
                        inflight.append(pool.submit(load, nxt[0]))

                top_up()
                while inflight:
                    p, img, err = inflight.popleft().result()
                    top_up()
                    if err is not None:
                        if not safe_put(("error", str(p), err)):
                            return
                        continue
                    imgs.append(img)
                    paths.append(str(p))
                    if len(imgs) == batch_size:
                        if not safe_put(("batch", paths, stack(imgs))):
                            return
                        imgs, paths = [], []
            if imgs and not safe_put(("batch", paths, stack(imgs))):
                return
            safe_put(None)
        except BaseException as e:  # surfaced in the consumer, not a hang
            safe_put(e)

    thread = threading.Thread(target=producer, daemon=True,
                              name="infer-prefetch")
    thread.start()
    try:
        while True:
            evt = out_q.get()
            if evt is None:
                break
            if isinstance(evt, BaseException):
                raise evt
            yield evt
    finally:
        stop.set()
        # drain so a blocked producer can exit
        while thread.is_alive():
            try:
                out_q.get_nowait()
            except queue.Empty:
                break
