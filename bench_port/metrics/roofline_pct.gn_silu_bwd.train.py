"""Share of its roofline of the GroupNorm(+SiLU) backward (kernel F): the
least time of its calls over the device time of the work launched inside
each call's range."""

from bench_port import readers


def wraps(ctx):
    return [readers.GN_SILU_BWD]


def read(data, ctx):
    return data.roofline_pct("gn_silu_bwd")
