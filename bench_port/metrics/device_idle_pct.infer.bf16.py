"""Share of the traced window in which no kernel, copy or memset ran on
the device.

The bf16 cell's copy: it moves ``infer_images_per_s.bf16``."""

from bench_port import readers


def read(data, ctx):
    return readers.idle_pct(data, ctx)
