"""Mean host milliseconds of a ``TaggerEngine.classify_async`` call (the
pinned copy and the launches queued), timed by the benchmark's clock
around each call of the traced window.

The bf16 cell's copy: it moves ``infer_images_per_s.bf16``."""

from bench_port import readers


def read(data, ctx):
    return readers.enqueue_ms(data, ctx)
