"""Mean host milliseconds of the program's ``engine.place`` spans in the
traced window: a batch's pinned staging copy and its host-to-device copy
queued, inside ``TaggerEngine.classify_async``."""

from bench_port import program_spans


def read(data, ctx):
    return program_spans.of(ctx).mean_ms("engine.place")
