"""Square image decode for inference (the port's copy of the square path of
``vae_tagger_tpu/data/bucketing.py``), PIL only.

The reference's inference transform resizes every image to
(resolution, resolution) with PIL's BILINEAR filter, distorting the aspect
ratio.  The native C++ decoder of the JAX package waits for a later slice.
"""

from __future__ import annotations

import io

import numpy as np
from PIL import Image


def decode_bytes_square(data: bytes, resolution: int) -> np.ndarray:
    """Raw image bytes -> (resolution, resolution, 3) uint8; raises on
    undecodable bytes."""
    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img.resize((resolution, resolution), Image.BILINEAR),
                      dtype=np.uint8)


def load_and_transform_image(path, resolution: int) -> np.ndarray:
    """Decode an image file and square-resize it; HWC uint8 (normalization
    to [-1, 1] happens on the device, ops/image.py)."""
    with open(path, "rb") as f:
        return decode_bytes_square(f.read(), resolution)
