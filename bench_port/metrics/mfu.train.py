"""The whole traced window's share of the card's peak: the operations the
cell's mathematics needs (bench_port/arith.py) for the work done in the
window, over the window, over the peak of the configuration's dtype."""

from bench_port import readers


def read(data, ctx):
    return readers.mfu_pct(data, ctx)
