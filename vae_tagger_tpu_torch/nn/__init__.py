from .blocks import (
    Conv2D,
    DownEncoderBlock,
    Downsample,
    GroupNorm,
    MidBlock,
    ResnetBlock,
    UpDecoderBlock,
    Upsample,
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
    "UpDecoderBlock",
    "Upsample",
    "VAEAttention",
    "seeded_init_",
]
