"""On-device image ops (counterpart of ``vae_tagger_tpu/ops/image.py``).

The host ships uint8 pixels to the device (4x fewer bytes than fp32) and
they are normalized there.
"""

from __future__ import annotations

import torch


def normalize_uint8(pixels, dtype=torch.float32):
    """HWC/NHWC uint8 [0, 255] -> ``dtype`` in [-1, 1].

    Matches ToTensor (x/255) + Normalize(mean .5, std .5): x/127.5 - 1.
    """
    return pixels.to(dtype) / 127.5 - 1.0
