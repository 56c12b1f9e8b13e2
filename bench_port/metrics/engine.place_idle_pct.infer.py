"""Share of the traced window in which the device was idle while the
program's ``engine.place`` span (a batch's pinned staging copy and its
host-to-device copy queued) was open on the host: the part of
``device_idle_pct`` that placing the next batch accounts for."""

from bench_port import program_spans


def read(data, ctx):
    return program_spans.of(ctx).idle_overlap_pct("engine.place")
