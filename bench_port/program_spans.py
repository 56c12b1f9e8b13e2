"""The program's own spans in a traced run, for the per-layer readers.

While a profiler runs, the port opens ``record_function`` ranges named
``vt:<name>`` inside itself (``vae_tagger_tpu_torch/utils/profiling.py``
lists them): ``engine.place`` around a batch's pinned staging copy and
its host-to-device copy, ``op.<name>`` around every ``ops/`` call on the
models' path and ``op.<name>.bwd`` around the backward of each of their
autograd Functions, and more.  They share the profiler's clock with the
device's records, so an idle stretch of the device can be set against
what the host was doing, and each launch can be placed inside or outside
the ``op.*`` ranges.

:func:`of` reads the traced window's events once per run into a
:class:`ProgramSpans`.  A program that opens no such span (a commit from
before them) leaves every reading None.

- :meth:`ProgramSpans.mean_ms`: the mean host milliseconds of one span
  name, over the spans opened in the window;
- :meth:`ProgramSpans.idle_overlap_pct`: the share of the window in which
  the device was idle while a span of one name was open on the host;
- :meth:`ProgramSpans.device_split`: the window's device time (kernels,
  copies, memsets; the profiler's annotations left out) split by where
  its work was launched: inside an ``op.*`` range on the launching
  thread, outside every one of them (glue), or from a call the trace does
  not hold.  A launch call is placed by its thread and its start time;
  its device work is joined to it by correlation id, as
  ``TraceData._op_times`` joins them.  Work launched from autograd's
  thread is placed by that thread's ranges (:meth:`ProgramSpans.in_op`).
  Inside counts all that an ``ops/`` function launches: its own dtype
  casts and packing, and cuDNN's convs under ``op.conv2d_nhwc``, beside
  the hand-written kernels; the pinned set of ranges a train step opens
  (``tests/test_torch_spans.py``) keeps that boundary where it is.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from .trace import DEVICE_WORK_CALLS, WINDOW, _merge
from .trace import PREFIX as BENCH_PREFIX

# the program's prefix of every span name, and of its ops' ranges (after it)
PREFIX = "vt:"
OP = "op."


def of(ctx) -> "ProgramSpans":
    """The program's spans of ``ctx``'s traced window, read once a run."""
    spans = getattr(ctx, "program_spans", None)
    if spans is None:
        spans = ctx.program_spans = ProgramSpans(ctx.tracer.prof.events())
    return spans


def _overlap(a: list, b: list) -> float:
    """Total length shared by two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class ProgramSpans:
    """The program's spans and the device's work of one traced window
    (times in the profiler's microseconds)."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        win = [e for e in cpu if e.name == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no bench:window range")
        self.w0, self.w1 = win[0].time_range.start, win[0].time_range.end
        # name -> [(start, end, thread)] of the spans opened in the window
        self.spans = defaultdict(list)
        for e in cpu:
            if e.name.startswith(PREFIX) and \
                    self.w0 <= e.time_range.start < self.w1:
                self.spans[e.name[len(PREFIX):]].append(
                    (e.time_range.start, e.time_range.end, e.thread))
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith((BENCH_PREFIX, PREFIX))]
        # (start, end) clipped to the window, by correlation id
        self.work = defaultdict(list)
        for e in device:
            a, b = e.time_range.start, e.time_range.end
            if b > self.w0 and a < self.w1:
                self.work[e.id].append((max(a, self.w0), min(b, self.w1)))
        # the runtime's launch calls: (start, thread, correlation id, name)
        self.calls = [(e.time_range.start, e.thread, e.id, e.name)
                      for e in cpu if DEVICE_WORK_CALLS.match(e.name)]
        # thread -> the merged ``op.*`` ranges opened on it, and their starts
        ranges = defaultdict(list)
        for name, spans in self.spans.items():
            if name.startswith(OP):
                for a, b, thread in spans:
                    ranges[thread].append((a, b))
        self._ops = {t: _merge(ivs) for t, ivs in ranges.items()}
        self._op_starts = {t: [a for a, _ in ivs]
                           for t, ivs in self._ops.items()}

    def in_op(self, thread, t) -> bool:
        """Whether an ``op.*`` range was open on ``thread`` at time ``t``."""
        ivs = self._ops.get(thread)
        if not ivs:
            return False
        i = bisect.bisect_right(self._op_starts[thread], t) - 1
        return i >= 0 and t <= ivs[i][1]

    def mean_ms(self, name: str):
        """Mean host ms of the ``name`` spans of the window, or None."""
        spans = self.spans.get(name)
        if not spans:
            return None
        return sum(b - a for a, b, _ in spans) / len(spans) / 1e3

    def idle_overlap_pct(self, name: str):
        """100 x (the window's device-idle time while a ``name`` span was
        open) / (the window), or None without such a span or without any
        device work."""
        spans = self.spans.get(name)
        if not spans or not self.work:
            return None
        busy = _merge([iv for ivs in self.work.values() for iv in ivs])
        idle, t = [], self.w0
        for a, b in busy:
            if a > t:
                idle.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            idle.append((t, self.w1))
        open_ = _merge([(a, min(b, self.w1)) for a, b, _ in spans])
        return 100.0 * _overlap(idle, open_) / (self.w1 - self.w0)

    def device_split(self) -> dict:
        """The window's device seconds: ``total``, and of it ``inside``
        (launched inside an ``op.*`` range on the launching thread),
        ``glue`` (launched outside every one) and ``unjoined`` (no launch
        call in the trace joins it)."""
        seconds = {"inside": 0.0, "glue": 0.0}
        joined = set()
        for start, thread, cid, _ in self.calls:
            work = self.work.get(cid)
            if not work or cid in joined:
                continue
            joined.add(cid)
            where = "inside" if self.in_op(thread, start) else "glue"
            seconds[where] += sum(b - a for a, b in work) / 1e6
        total = sum(b - a for ivs in self.work.values()
                    for a, b in ivs) / 1e6
        return {"total": total, **seconds,
                "unjoined": total - seconds["inside"] - seconds["glue"]}

    def glue_pct(self):
        """100 x (the window's device time launched outside every ``op.*``
        range) / (all the window's device time), or None without an
        ``op.*`` range or without any device work."""
        if not any(n.startswith(OP) for n in self.spans):
            return None
        split = self.device_split()
        if split["total"] <= 0:
            return None
        return 100.0 * split["glue"] / split["total"]
