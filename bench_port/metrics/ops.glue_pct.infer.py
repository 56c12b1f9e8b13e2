"""Share of the traced window's device time (kernels, copies, memsets)
whose work was launched outside every one of the program's ``op.*``
ranges: torch's glue between the ``ops/`` calls (the residual adds and
dtype copies between them, the head's dense layers, the losses, the
optimizer), set beside the device time of all that the ops launch (their
own casts and cuDNN's convs included; ``program_spans.py``)."""

from bench_port import program_spans


def read(data, ctx):
    return program_spans.of(ctx).glue_pct()
