"""Mean host milliseconds of a ``TaggerEngine.classify_async`` call (the
pinned copy and the launches queued), timed by the benchmark's clock
around each call of the traced window."""

from bench_port import readers


def read(data, ctx):
    return readers.enqueue_ms(data, ctx)
