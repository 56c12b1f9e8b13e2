"""What the per-layer metric files share: the op ranges they open in a
traced run (module, wrapper, op name, cost of one call from its
arguments' shapes) and the arithmetic of a share of a peak."""

from __future__ import annotations

from . import arith


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _conv_cost(x, gn_scale, gn_bias, kernel, bias, residual=None,
               shortcut_kernel=None, shortcut_bias=None, **_):
    n, h, w, c_in = x.shape
    c_res = 0 if residual is None else residual.shape[-1]
    return (*arith.gn_silu_conv3x3(n, h, w, c_in, kernel.shape[-1], c_res,
                                   shortcut_kernel is not None, _dtype(x)),
            _dtype(x))


def _attn_cost(q, k, v):
    b, sq, d = q.shape
    return (*arith.flash_attention_fwd(b, sq, k.shape[1], d, _dtype(q)),
            _dtype(q))


def _gn_bwd_cost(x, *_, **__):
    n, h, w, c = x.shape
    return (*arith.group_norm_silu_bwd(n, h, w, c, _dtype(x)), _dtype(x))


# the ResnetBlock's fused branch, looked up by name in nn/blocks.py
GN_SILU_CONV3X3 = ("vae_tagger_tpu_torch.nn.blocks", "gn_silu_conv3x3",
                   "gn_silu_conv3x3", _conv_cost)
# the attention forward, looked up by name by ops/attention.py's Function
FLASH_ATTN_FWD = ("vae_tagger_tpu_torch.ops.attention", "flash_attention_fwd",
                  "flash_attn_fwd", _attn_cost)
# the GroupNorm(+SiLU) backward, looked up by name by its Functions
GN_SILU_BWD = ("vae_tagger_tpu_torch.ops.normalization",
               "group_norm_silu_backward", "gn_silu_bwd", _gn_bwd_cost)


def mfu_pct(data, ctx):
    """100 x (the cell's operations done in the traced window) / (the
    window) / (the peak of the configuration's compute dtype)."""
    flops = data.counters.get("flops")
    if not flops:
        return None
    peak = arith.PEAK_FLOPS[data.counters["dtype"]]
    return 100.0 * flops / data.window_s / peak


def enqueue_ms(data, ctx):
    """Mean host ms of the ``classify_async`` calls the traffic timed."""
    calls = data.counters.get("enqueue_s")
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)


def idle_pct(data, ctx):
    return 100.0 * data.idle_share()
