"""Share of its roofline of the mid-block attention forward (C' in bf16,
C'' in fp32): the least time of its calls over the device time of the
work launched inside each call's range.

The bf16 cell's copy: it moves ``infer_images_per_s.bf16``."""

from bench_port import readers


def wraps(ctx):
    return [readers.FLASH_ATTN_FWD]


def read(data, ctx):
    return data.roofline_pct("flash_attn_fwd")
