"""On-device image ops (counterpart of ``vae_tagger_tpu/ops/image.py``).

The host ships uint8 pixels to the device (4x fewer bytes than fp32) and
they are normalized there.  The YUV 4:2:0 wire format ships a full-size
luma plane and quarter-size chroma (1.5 bytes a pixel, half of RGB's); the
device turns the planes back into uint8 RGB before normalizing.  The JAX
package does this in XLA, not in a Pallas kernel, so plain PyTorch on the
device is its port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import ranged


@ranged("op.normalize_uint8")
def normalize_uint8(pixels, dtype=torch.float32):
    """HWC/NHWC uint8 [0, 255] -> ``dtype`` in [-1, 1].

    Matches ToTensor (x/255) + Normalize(mean .5, std .5): x/127.5 - 1.
    """
    return pixels.to(dtype) / 127.5 - 1.0


@ranged("op.yuv420_to_rgb_uint8")
def yuv420_to_rgb_uint8(y, cbcr):
    """Planar YUV 4:2:0 uint8 -> NHWC uint8 RGB, on the planes' device.

    The chroma is upsampled 2x bilinearly at half-pixel centres (JFIF's
    centred chroma siting; ``align_corners=False`` clamps at the borders
    as ``jax.image.resize(..., "linear")`` renormalizes there), converted
    with the BT.601 full-range matrix, then rounded half to even and
    clamped to the uint8 grid.

    Args:
      y:    (B, H, W) uint8 luma.
      cbcr: (B, 2, H/2, W/2) uint8 chroma (the Cb plane, then Cr).

    Returns (B, H, W, 3) uint8 RGB.
    """
    b, h, w = y.shape
    yf = y.float()
    cf = F.interpolate(cbcr.float() - 128.0, size=(h, w), mode="bilinear",
                       align_corners=False)
    cb, cr = cf[:, 0], cf[:, 1]
    r = yf + 1.402 * cr
    g = yf - 0.344136 * cb - 0.714136 * cr
    bl = yf + 1.772 * cb
    rgb = torch.stack([r, g, bl], dim=-1)
    return torch.round(rgb).clamp_(0.0, 255.0).to(torch.uint8)


def yuv420_to_normalized_rgb(y, cbcr, dtype=torch.float32):
    """Planar YUV 4:2:0 uint8 -> NHWC RGB in [-1, 1] of ``dtype``: the
    YUV wire format's counterpart of :func:`normalize_uint8`."""
    return normalize_uint8(yuv420_to_rgb_uint8(y, cbcr), dtype)


def rgb_to_yuv420_reference(rgb_u8):
    """Host-side numpy oracle: HWC uint8 RGB -> (Y, CbCr) planar 4:2:0.

    The BT.601 full-range forward matrix, 2x2 box-averaged chroma, rounded
    half to even and clamped.  H and W must be even."""
    x = np.asarray(rgb_u8).astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    yp = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    y_out = np.clip(np.round(yp), 0, 255).astype(np.uint8)

    def box2(p):
        return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                + p[1::2, 1::2]) * 0.25

    cbcr = np.stack([box2(cb), box2(cr)])
    return y_out, np.clip(np.round(cbcr), 0, 255).astype(np.uint8)
