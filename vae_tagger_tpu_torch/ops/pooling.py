"""Adaptive pooling over NHWC tensors (counterpart of
``vae_tagger_tpu/ops/pooling.py``).

Torch's ``AdaptiveAvgPool2d((oh, ow))`` splits each spatial axis into bins
``[floor(i*S/O), ceil((i+1)*S/O))``.  When S % O == 0 every bin has the same
size and the op is a reshape and a mean, which covers every call site of
the tagger heads; the uneven case contracts with a bin matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import ranged


def _bin_matrix(in_size: int, out_size: int, average: bool) -> np.ndarray:
    """(in_size, out_size) matrix M with M[s, o] = weight of input s in
    output o."""
    m = np.zeros((in_size, out_size), dtype=np.float32)
    for o in range(out_size):
        start = (o * in_size) // out_size
        end = -(-((o + 1) * in_size) // out_size)  # ceil
        m[start:end, o] = 1.0 / (end - start) if average else 1.0
    return m


def _pair(output_size):
    if isinstance(output_size, int):
        return output_size, output_size
    return tuple(output_size)


@ranged("op.adaptive_avg_pool_nhwc")
def adaptive_avg_pool_nhwc(x, output_size):
    """Adaptive average pool of an NHWC tensor to (oh, ow)."""
    oh, ow = _pair(output_size)
    n, h, w, c = x.shape
    if h == oh and w == ow:
        return x
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, oh, h // oh, ow, w // ow, c).mean(dim=(2, 4))
    mh = torch.from_numpy(_bin_matrix(h, oh, True)).to(x)
    mw = torch.from_numpy(_bin_matrix(w, ow, True)).to(x)
    y = torch.einsum("nhwc,ho->nowc", x, mh)
    return torch.einsum("nowc,wp->nopc", y, mw)


@ranged("op.adaptive_max_pool_nhwc")
def adaptive_max_pool_nhwc(x, output_size):
    """Adaptive max pool of an NHWC tensor to (oh, ow) (even division; the
    heads only max-pool to 1x1)."""
    oh, ow = _pair(output_size)
    n, h, w, c = x.shape
    if oh == 1 and ow == 1:
        return x.amax(dim=(1, 2), keepdim=True)
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, oh, h // oh, ow, w // ow, c).amax(dim=(2, 4))
    raise NotImplementedError("uneven adaptive max pool is not needed by any "
                              "call site")
