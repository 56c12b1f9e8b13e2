"""The 3xTF32 split that kernels B'', C'', D'' and E'' multiply with.

The tensor cores multiply fp32 data as TF32 (10 mantissa bits).  Kernels
B'' (``csrc/gn_silu_conv3x3_tf32x3.cu``), C''
(``csrc/flash_attention_fwd_tf32x3.cu``), D'' and E''
(``csrc/flash_attention_bwd_tf32x3.cu``) keep fp32-level error by splitting
each operand x into ``hi = tf32(x)`` and ``lo = tf32(x - hi)`` and
accumulating ``lo*hi + hi*lo + hi*hi`` in fp32.  The operands they read
from shared memory (the conv weights; K, V and the transposes of the
attention) are split here by the wrappers, as a preparation pass of every
call; the others are split in registers with ``cvt.rna.tf32.f32``, which
:func:`to_tf32` emulates bit for bit.

tf32 ``wgmma`` reads shared-memory operands K-major only, so a product
that sums over the sequence (P V, dS K, P^T dO, dS^T Q) takes its B
operand transposed, with the sequence contiguous: :func:`transpose_permuted`.
"""

from __future__ import annotations

import torch

# the 13 low mantissa bits that TF32 drops, and half of their range
_DROP = 0x1FFF
_HALF = 0x1000


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, the low 13 mantissa bits zero.  Inf and
    NaN pass unchanged."""
    if x.dtype != torch.float32:
        raise TypeError(f"to_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    # sign and magnitude: adding half an ulp of TF32 to the bit pattern
    # rounds the magnitude half away from zero; a carry moves the exponent
    rounded = ((bits + _HALF) & ~_DROP).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi), both fp32 tensors of
    x's shape; hi + lo is x to within 2^-22 of |x|."""
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


# position p of a group of 8 along the summed index holds element PERM8[p]:
# the order in which a thread's S (or S^T) accumulators hold the streamed
# rows (2t and 2t + 1 beside k indices t and t + 4), so the kernels store P
# or dS as the A operand with no shuffle
PERM8 = (0, 2, 4, 6, 1, 3, 5, 7)


def transpose_permuted(x: torch.Tensor):
    """(x^T, s_pad) of x (B, S, D): x^T is (B, D, s_pad), contiguous, S
    rounded up to a multiple of 8 with zeros, each group of 8 along it in
    the order :data:`PERM8`."""
    b, s, d = x.shape
    s_pad = -(-s // 8) * 8
    xp = x.new_zeros(b, s_pad, d)
    xp[:, :s] = x
    # (.., 4, 2) -> (.., 2, 4): position 4e + a holds element 2a + e
    xt = (xp.view(b, s_pad // 8, 4, 2, d).transpose(2, 3)
          .reshape(b, s_pad, d).transpose(1, 2).contiguous())
    return xt, s_pad
