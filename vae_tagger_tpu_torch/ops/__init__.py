"""Ops of the port: plain PyTorch versions and the CUDA kernel wrappers."""

from .attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    spatial_single_head_attention,
)
from .conv import conv2d_nhwc, gn_silu_conv3x3
from .image import normalize_uint8
from .normalization import (
    group_norm,
    group_norm_affine,
    group_norm_silu,
    group_stats,
    layer_norm,
)
from .pooling import adaptive_avg_pool_nhwc, adaptive_max_pool_nhwc

__all__ = [
    "adaptive_avg_pool_nhwc",
    "adaptive_max_pool_nhwc",
    "conv2d_nhwc",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "gn_silu_conv3x3",
    "group_norm",
    "group_norm_affine",
    "group_norm_silu",
    "group_stats",
    "layer_norm",
    "normalize_uint8",
    "spatial_single_head_attention",
]
