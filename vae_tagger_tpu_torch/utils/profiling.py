"""Profiling and throughput helpers (the port's counterpart of
``vae_tagger_tpu/utils/profiling.py``):

- :func:`trace`: a torch.profiler capture around a block of code, CPU and
  (where there is a card) CUDA activities, written as a chrome trace; the
  trainers have their own ``--profile_steps`` capture (train/loop.py);
- :class:`ThroughputMeter`: the images/s meter of the inference loops.
"""

from __future__ import annotations

import contextlib
import os
import time


def activities() -> list:
    """torch.profiler's activities: the CPU, and CUDA where there is a
    card."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def write_trace(prof, log_dir: str) -> str:
    """Write a finished capture as ``<log_dir>/trace.json`` (chrome trace
    format); returns the path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str = "profile"):
    """Capture a torch.profiler trace around a block (the card's work
    queued in it included) and write it to ``<log_dir>/trace.json``;
    yields the profiler."""
    import torch

    with torch.profiler.profile(activities=activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    write_trace(prof, log_dir)
    print(f"profiler trace written to {log_dir}")


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
