"""Mean host milliseconds of the program's ``engine.place`` spans in the
traced window: a batch's pinned staging copy and its host-to-device copy
queued, inside ``TaggerEngine.classify_async``.

The bf16 cell's copy: it moves ``infer_images_per_s.bf16``."""

from bench_port import program_spans


def read(data, ctx):
    return program_spans.of(ctx).mean_ms("engine.place")
