"""Profiling and throughput helpers (the port's counterpart of
``vae_tagger_tpu/utils/profiling.py``):

- :func:`trace`: a torch.profiler capture around a block of code, CPU and
  (where there is a card) CUDA activities, written as a chrome trace; the
  trainers have their own ``--profile_steps`` capture (train/loop.py);
- :func:`span` and :func:`ranged`: the program's own spans, a
  ``record_function`` range named ``vt:<name>`` around a block or every
  call of a function, so they land in the profiler's trace beside the
  card's kernels and copies, on the same clock.  While no profiler runs
  they open nothing: one ``torch.autograd._profiler_enabled()`` check,
  where entering a range costs some fifty times as much on a host CPU;
- :class:`ThroughputMeter`: the images/s meter of the inference loops.

The spans, by where they are opened (every name carries the ``vt:``
prefix in the trace):

- ``engine.place``: the host batch's pinned staging copy and the
  host-to-device copy queued (``_place``; ``_place_yuv`` with the YUV
  planes' conversion to RGB on the device; infer/engine.py);
- ``steps.train_step``: one train micro-step (``FullSteps`` and
  ``VaeSteps.train_step``; ``DecoderSteps.train_step_from_latents``, the
  head's step, which ``DecoderSteps.train_step`` and train_decoder's loop
  call after placing and encoding the batch), holding its phases
  ``steps.forward`` (the losses), ``steps.backward`` (``backward()``) and
  ``steps.optimizer`` (``Optimizer.step``), and
  ``steps.grad_allreduce`` (the gradients' average across processes,
  inside ``steps.optimizer``; empty with one process);
- ``steps.place``: a host batch's host-to-device copies
  (``batch_to_device``, in train and eval steps alike);
- ``loop.data``: the epoch loop waiting on the train loader for the next
  batch (train/loop.py);
- ``op.<name>``: every call of an ``ops/`` function on the models' path:
  ``conv2d_nhwc``, ``gn_silu_conv3x3``, ``gn_silu_conv3x3_from_stats``,
  ``rms_silu_conv3x3`` (the Wan VAE's fused branch; ops/conv.py);
  ``spatial_single_head_attention``,
  ``spatial_single_head_attention_sharded``, ``flash_attention_fwd``
  (ops/attention.py); ``group_norm_silu``, ``group_norm_silu_from_stats``,
  ``group_stats_with_grad``, ``group_norm_silu_backward`` (kernel F),
  ``rms_norm_stats`` and ``rms_norm_silu`` (the Wan VAE's RMS stats and
  apply passes; ops/normalization.py); ``normalize_uint8``,
  ``yuv420_to_rgb_uint8`` (ops/image.py); ``adaptive_avg_pool_nhwc``, ``adaptive_max_pool_nhwc``
  (ops/pooling.py);
- ``op.<name>.bwd``: the backward of each autograd Function there:
  ``op.gn_silu_conv3x3.bwd``, ``op.gn_silu_conv3x3_from_stats.bwd``,
  ``op.flash_attention.bwd``, ``op.group_norm_silu.bwd``,
  ``op.group_norm_silu_from_stats.bwd``, ``op.group_stats_with_grad.bwd``.

Ranges nest: a range opened inside another (``op.group_norm_silu_backward``
inside ``op.gn_silu_conv3x3.bwd``, an op inside ``steps.forward``) is its
child in the trace.  A backward range is opened on the thread autograd
runs it on.  The launch counters (ops/backend.py) count launches with or
without a profiler.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch.autograd import _profiler_enabled

# the program's prefix of every span name in a trace
PREFIX = "vt:"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range ``vt:<name>`` while a profiler runs,
    else nothing."""
    if not _profiler_enabled():
        return _OFF
    return torch.autograd.profiler.record_function(PREFIX + name)


def ranged(name: str):
    """A decorator: every call of the function inside the range
    ``vt:<name>`` while a profiler runs, else the bare call."""
    label = PREFIX + name

    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with torch.autograd.profiler.record_function(label):
                return fn(*args, **kwargs)
        return call
    return decorate


def spanned(iterable, name: str):
    """The items of ``iterable``, each ``next`` inside the span
    ``name``."""
    it = iter(iterable)
    while True:
        with span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def activities() -> list:
    """torch.profiler's activities: the CPU, and CUDA where there is a
    card."""
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
