"""Spans, op ranges and the device trace of a traced run.

The benchmark's spans are ``record_function`` ranges named ``bench:<span>``
that it opens around its own calls into the program (placing a batch,
``classify_async``, waiting on a result, ``train_step``).  An op range
``bench:op:<op>`` is opened around each call of one of the program's
``ops/`` wrappers, by replacing the wrapper where its caller looks it
up, for the traced run only; each call's operations and bytes are
counted from its arguments' shapes (arith.py) when it is made.

After the traced window, :meth:`Tracer.data` reads the profiler's events
once into a :class:`TraceData`:

- the traced window, the host range ``bench:window``;
- the device's work (kernels, copies, memsets; the profiler's annotations
  left out), its union within the window (``busy_s``) and the gaps in it,
  each labelled by the innermost ``bench:`` span open on the host at the
  gap's start;
- each op range's device time: the work launched while the range was open,
  found from the runtime's launch calls and joined to the device's records
  by correlation id (a ctypes launch has no operator to link it to), as
  ``chip_smoke.py``'s ``_f_range_kernels`` does;
- the device time by kernel name.
"""

from __future__ import annotations

import contextlib
import importlib
import re
from collections import defaultdict

PREFIX = "bench:"
OP_PREFIX = "bench:op:"
WINDOW = "bench:window"
# CUDA runtime and driver calls that put work on the device
DEVICE_WORK_CALLS = re.compile(r"^cu(da)?(Launch|Memcpy|Memset|GraphLaunch)")


class Tracer:
    """Spans and op ranges for one run; inert unless ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.op_costs = defaultdict(list)   # op -> [(flops, bytes, dtype)]
        self.counters = {}                  # set by the traffic driver
        self._patched = []

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(PREFIX + name)

    def wrap(self, module: str, attr: str, op: str, cost):
        """Open ``bench:op:<op>`` around every call of ``module.attr`` and
        record ``cost(*args, **kwargs)`` -> (flops, bytes, dtype) for it."""
        if not self.on:
            return
        from torch.profiler import record_function

        mod = importlib.import_module(module)
        inner = getattr(mod, attr)
        costs = self.op_costs[op]

        def ranged(*args, **kwargs):
            costs.append(cost(*args, **kwargs))
            with record_function(OP_PREFIX + op):
                return inner(*args, **kwargs)

        setattr(mod, attr, ranged)
        self._patched.append((mod, attr, inner))

    def unwrap(self):
        for mod, attr, inner in reversed(self._patched):
            setattr(mod, attr, inner)
        self._patched.clear()

    @contextlib.contextmanager
    def window(self):
        """Profile the block; the op costs recorded before it are dropped."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        for costs in self.op_costs.values():
            costs.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        self.prof = prof

    def data(self) -> "TraceData":
        return TraceData(self.prof.events(), self.op_costs, self.counters)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class TraceData:
    """What the per-layer readers read (times in seconds)."""

    def __init__(self, events, op_costs, counters):
        from torch.autograd import DeviceType

        self.op_costs = {k: list(v) for k, v in op_costs.items()}
        self.counters = dict(counters)
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        win = [e for e in cpu if e.name == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no bench:window range")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        self.window_s = (w1 - w0) / 1e6
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith(PREFIX)]
        work = [(e.time_range.start, e.time_range.end) for e in device
                if e.time_range.end > w0 and e.time_range.start < w1]
        busy = _merge([(max(a, w0), min(b, w1)) for a, b in work])
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self.kernels = len(work)
        by_name = defaultdict(float)
        for e in device:
            by_name[e.name] += e.time_range.elapsed_us() / 1e6
        self.device_by_name = dict(by_name)
        spans = [e for e in cpu if e.name.startswith(PREFIX)
                 and e.name != WINDOW and not e.name.startswith(OP_PREFIX)]
        self.gaps = self._gaps(busy, w0, w1, spans)
        self.op_device_s = self._op_times(events, cpu, device)

    @staticmethod
    def _gaps(busy, w0, w1, spans):
        """[(label, seconds)] of every idle stretch of the window."""
        edges, t = [], w0
        for a, b in busy:
            if a > t:
                edges.append((t, a))
            t = max(t, b)
        if w1 > t:
            edges.append((t, w1))
        out = []
        for a, b in edges:
            open_ = [s for s in spans
                     if s.time_range.start <= a < s.time_range.end]
            inner = max(open_, key=lambda s: s.time_range.start, default=None)
            label = (inner.name[len(PREFIX):] if inner is not None
                     else "outside the benchmark's spans")
            out.append((label, (b - a) / 1e6))
        return out

    @staticmethod
    def _op_times(events, cpu, device):
        """{op: [device seconds of each call, in call order]}."""
        by_id = {e.id: e for e in device}
        calls = sorted((e for e in cpu if DEVICE_WORK_CALLS.match(e.name)),
                       key=lambda e: e.time_range.start)
        starts = [c.time_range.start for c in calls]
        import bisect

        out = defaultdict(list)
        ranges = sorted((e for e in cpu if e.name.startswith(OP_PREFIX)),
                        key=lambda e: e.time_range.start)
        for r in ranges:
            i = bisect.bisect_left(starts, r.time_range.start)
            us = 0.0
            while i < len(calls) and starts[i] <= r.time_range.end:
                work = by_id.get(calls[i].id)
                if work is not None:
                    us += work.time_range.elapsed_us()
                i += 1
            out[r.name[len(OP_PREFIX):]].append(us / 1e6)
        return dict(out)

    # ---------------------------------------------------------- readers

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def roofline_pct(self, op: str):
        """100 x (least time of every call of ``op``) / (its device time),
        or None where the window holds no call of it."""
        from . import arith

        costs, times = self.op_costs.get(op, []), self.op_device_s.get(op, [])
        if not costs or len(costs) != len(times) or sum(times) <= 0:
            return None
        least = sum(arith.least_seconds(f, b, dt) for f, b, dt in costs)
        return 100.0 * least / sum(times)

    def breakdown(self) -> dict:
        ops = sorted(self.device_by_name.items(), key=lambda kv: -kv[1])[:10]
        by_label = defaultdict(lambda: [0.0, 0, 0.0])
        for label, s in self.gaps:
            agg = by_label[label]
            agg[0] += s
            agg[1] += 1
            agg[2] = max(agg[2], s)
        gaps = sorted(by_label.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[f"{label} ({n} gaps, longest {m} s)", s]
                              for label, (s, n, m) in gaps]}
