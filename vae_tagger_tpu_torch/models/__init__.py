from .autoencoder_kl import (
    AutoencoderKL,
    Decoder,
    DiagonalGaussian,
    Encoder,
    decode_scaled,
    encode_scaled,
)
from .autoencoder_kl_wan import AutoencoderKLWan
from .taggers import (
    AttentionClassificationDecoder,
    ClassificationDecoder,
    CrossAttention,
    MultiHeadSelfAttention,
    SpatialAttention,
    create_attention_decoder,
    get_attention_maps,
)

__all__ = [
    "AttentionClassificationDecoder",
    "AutoencoderKL",
    "AutoencoderKLWan",
    "ClassificationDecoder",
    "CrossAttention",
    "Decoder",
    "DiagonalGaussian",
    "Encoder",
    "MultiHeadSelfAttention",
    "SpatialAttention",
    "create_attention_decoder",
    "decode_scaled",
    "encode_scaled",
    "get_attention_maps",
]
