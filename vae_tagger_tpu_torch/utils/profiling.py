"""Throughput meter (the port's copy of ``ThroughputMeter`` from
``vae_tagger_tpu/utils/profiling.py``)."""

from __future__ import annotations

import time


class ThroughputMeter:
    """Images/sec since the last reset, on the host clock."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._count = 0

    def update(self, n: int):
        self._count += n

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._count / dt if dt > 0 else 0.0

    def report(self, prefix: str = "") -> str:
        return f"{prefix}{self.images_per_sec:.2f} images/sec"
