"""Share of its roofline of the Wan VAE's fused residual-block branch
(``rms_silu_conv3x3``: the RMS stats pass, then B' in its RMS mode in
bf16, or the RMS apply pass and B'' in fp32): the least time of its calls
over the device time of the work launched inside each call's range.

A call's cost is the fused conv's (``arith.gn_silu_conv3x3``: the
products, and x, the residual, the weights and the output moved once)
plus one more read of x, the stats pass's.  In the Wan cell: it moves
``infer_images_per_s.bf16``."""

from bench_port import arith


def _cost(x, gamma, kernel, bias, residual=None, shortcut_kernel=None,
          shortcut_bias=None, **_):
    n, h, w, c_in = x.shape
    dtype = str(x.dtype).removeprefix("torch.")
    c_res = 0 if residual is None else residual.shape[-1]
    flops, nbytes = arith.gn_silu_conv3x3(
        n, h, w, c_in, kernel.shape[-1], c_res, shortcut_kernel is not None,
        dtype)
    return flops, nbytes + arith.ITEMSIZE[dtype] * n * h * w * c_in, dtype


# the Wan residual block's fused branch, looked up by name in nn/blocks.py
RMS_SILU_CONV3X3 = ("vae_tagger_tpu_torch.nn.blocks", "rms_silu_conv3x3",
                    "rms_silu_conv3x3", _cost)


def wraps(ctx):
    return [RMS_SILU_CONV3X3]


def read(data, ctx):
    return data.roofline_pct("rms_silu_conv3x3")
