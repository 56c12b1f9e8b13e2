from .blocks import (
    Conv2D,
    DownEncoderBlock,
    Downsample,
    GroupNorm,
    MidBlock,
    ResnetBlock,
    VAEAttention,
    seeded_init_,
)

__all__ = [
    "Conv2D",
    "DownEncoderBlock",
    "Downsample",
    "GroupNorm",
    "MidBlock",
    "ResnetBlock",
    "VAEAttention",
    "seeded_init_",
]
