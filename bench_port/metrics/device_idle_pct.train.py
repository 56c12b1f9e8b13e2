"""Share of the traced window in which no kernel, copy or memset ran on
the device."""

from bench_port import readers


def read(data, ctx):
    return readers.idle_pct(data, ctx)
