"""Share of its roofline of the fused GroupNorm+SiLU+conv3x3 op (B' in
bf16, B'' in fp32, with kernel A's stats pass): the least time of its calls
over the device time of the work launched inside each call's range."""

from bench_port import readers


def wraps(ctx):
    return [readers.GN_SILU_CONV3X3]


def read(data, ctx):
    return data.roofline_pct("gn_silu_conv3x3")
