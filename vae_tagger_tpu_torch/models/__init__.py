from .autoencoder_kl import AutoencoderKL, DiagonalGaussian, Encoder, encode_scaled
from .taggers import (
    AttentionClassificationDecoder,
    ClassificationDecoder,
    CrossAttention,
    MultiHeadSelfAttention,
    SpatialAttention,
    create_attention_decoder,
)

__all__ = [
    "AttentionClassificationDecoder",
    "AutoencoderKL",
    "ClassificationDecoder",
    "CrossAttention",
    "DiagonalGaussian",
    "Encoder",
    "MultiHeadSelfAttention",
    "SpatialAttention",
    "create_attention_decoder",
    "encode_scaled",
]
