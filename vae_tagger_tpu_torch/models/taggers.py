"""Tagger heads (classification decoders) in PyTorch over NHWC latents.

Counterpart of ``vae_tagger_tpu/models/taggers.py``:

  SpatialAttention               CBAM channel + spatial gate
  MultiHeadSelfAttention         pre-LN MHSA over the 64 pooled tokens
  CrossAttention                 one-query cross attention
  ClassificationDecoder          MLP head over 4x4-pooled latents
  AttentionClassificationDecoder the default attention tagger head

Submodules are ``nn.Sequential``s and layers named after the reference
``state_dict`` keys (``classifier.0``, ``feature_compress.1.running_mean``,
``spatial_attention.channel_att.2.weight``), so a reference
``pytorch_model.bin`` loads with ``load_state_dict`` 1:1.  The forwards take
NHWC latents, as the JAX heads do, and flatten channel-major like torch's
NCHW ``reshape``, so Linear weights carry over without permutation.  The
64-token MHSA stays plain PyTorch, as the JAX package keeps it on XLA.  In
``eval()`` mode dropout is off and BatchNorm reads its running stats.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import AttentionDecoderConfig
from ..ops.conv import conv2d_nhwc
from ..ops.pooling import adaptive_avg_pool_nhwc, adaptive_max_pool_nhwc


def _flatten_torch_order(x):
    """(B, H, W, C) -> (B, C*H*W), channel-major like torch NCHW."""
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def _conv(conv: nn.Conv2d, x):
    return conv2d_nhwc(x, conv.weight, conv.bias, conv.stride, conv.padding)


class SpatialAttention(nn.Module):
    """CBAM gate: channel attention (shared 1x1-conv bottleneck over avg-
    and max-pooled descriptors), then spatial attention (7x7 conv over the
    channel mean/max maps), each multiplied into the feature map."""

    def __init__(self, in_channels: int, reduction_ratio: int = 8):
        super().__init__()
        # clamped to >= 1 as in the JAX head (narrow latents)
        hidden = max(1, in_channels // reduction_ratio)
        self.channel_att = nn.Sequential(
            nn.Conv2d(in_channels, hidden, 1, bias=False),
            nn.ReLU(),
            nn.Conv2d(hidden, in_channels, 1, bias=False),
        )
        self.spatial_att = nn.Sequential(
            nn.Conv2d(2, 1, kernel_size=7, padding=3, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x):
        ca0, ca2 = self.channel_att[0], self.channel_att[2]

        def bottleneck(t):
            return _conv(ca2, F.relu(_conv(ca0, t)))

        channel_att = torch.sigmoid(
            bottleneck(adaptive_avg_pool_nhwc(x, 1))
            + bottleneck(adaptive_max_pool_nhwc(x, 1)))
        x = x * channel_att
        spatial = torch.cat([x.mean(dim=-1, keepdim=True),
                             x.amax(dim=-1, keepdim=True)], dim=-1)
        return x * torch.sigmoid(_conv(self.spatial_att[0], spatial))


class MultiHeadSelfAttention(nn.Module):
    """Pre-LayerNorm MHSA over the flattened spatial sequence of an NHWC
    map, dropout on the attention weights, residual add."""

    def __init__(self, embed_dim: int, num_heads: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} is not divisible by num_heads "
                f"{num_heads}; pass --attention_heads <divisor> or "
                f"--no_attention for narrow-latent VAEs")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.dropout = nn.Dropout(dropout)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        b, h, w, c = x.shape
        s = h * w
        seq = x.reshape(b, s, c)
        y = self.norm(seq)

        def heads(t):
            return t.reshape(b, s, self.num_heads, self.head_dim).transpose(
                1, 2)

        q, k, v = heads(self.q_proj(y)), heads(self.k_proj(y)), heads(
            self.v_proj(y))
        scores = q @ k.transpose(-2, -1) / (self.head_dim ** 0.5)
        weights = self.dropout(scores.float().softmax(dim=-1).to(q.dtype))
        out = (weights @ v).transpose(1, 2).reshape(b, s, c)
        return (self.out_proj(out) + seq).reshape(b, h, w, c)


class CrossAttention(nn.Module):
    """One query vector attending over a spatial K/V sequence; residual to
    the query."""

    def __init__(self, query_dim: int, key_dim: int, embed_dim: int = 256,
                 num_heads: int = 8):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = nn.Linear(query_dim, embed_dim)
        self.k_proj = nn.Linear(key_dim, embed_dim)
        self.v_proj = nn.Linear(key_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, query_dim)

    def forward(self, query, key_value):
        # query (B, Qd); key_value (B, S, Kd)
        b = query.shape[0]

        def heads(t):
            return t.reshape(b, -1, self.num_heads, self.head_dim).transpose(
                1, 2)

        q = heads(self.q_proj(query))
        k, v = heads(self.k_proj(key_value)), heads(self.v_proj(key_value))
        scores = q @ k.transpose(-2, -1) / (self.head_dim ** 0.5)
        weights = scores.float().softmax(dim=-1).to(q.dtype)
        out = (weights @ v).transpose(1, 2).reshape(b, self.embed_dim)
        return self.out_proj(out) + query


class ClassificationDecoder(nn.Module):
    """MLP head: AdaptiveAvgPool(4,4) -> Linear 512 -> LN -> LeakyReLU(0.2)
    -> Dropout(0.3) -> Linear 256 -> LN -> LeakyReLU -> Dropout(0.2) ->
    logits."""

    def __init__(self, latent_channels: int, num_classes: int):
        super().__init__()
        self.classifier = nn.Sequential(
            nn.Linear(latent_channels * 16, 512),
            nn.LayerNorm(512, eps=1e-5),
            nn.LeakyReLU(0.2),
            nn.Dropout(0.3),
            nn.Linear(512, 256),
            nn.LayerNorm(256, eps=1e-5),
            nn.LeakyReLU(0.2),
            nn.Dropout(0.2),
            nn.Linear(256, num_classes),
        )

    def forward(self, latents):
        x = adaptive_avg_pool_nhwc(latents, (4, 4))
        return self.classifier(_flatten_torch_order(x))


class AttentionClassificationDecoder(nn.Module):
    """The default tagger head: optional CBAM gate on the latent -> 3x3 conv
    C -> C/2 + BatchNorm + ReLU + AdaptiveAvgPool(8,8) -> optional MHSA over
    the 64 tokens -> 4-layer MLP -> logits, with an optional one-query
    cross-attention branch mixed into the flattened features."""

    def __init__(self, latent_channels: int, num_classes: int,
                 attention: AttentionDecoderConfig = AttentionDecoderConfig()):
        super().__init__()
        cfg = attention
        self.config = cfg
        c2 = latent_channels // 2
        self.spatial_attention = (SpatialAttention(latent_channels)
                                  if cfg.use_spatial_attention else None)
        # indices 0 and 1 carry the weights; the forward applies them NHWC
        self.feature_compress = nn.Sequential(
            nn.Conv2d(latent_channels, c2, 3, 1, 1),
            nn.BatchNorm2d(c2, eps=1e-5, momentum=0.1),
            nn.ReLU(),
            nn.AdaptiveAvgPool2d((8, 8)),
        )
        self.self_attention_post = (
            MultiHeadSelfAttention(c2, cfg.attention_heads,
                                   cfg.attention_dropout)
            if cfg.use_self_attention else None)
        if cfg.use_cross_attention:
            self.query_generator = nn.Linear(c2 * 64, 512)
            self.cross_attention = CrossAttention(512, c2, 256,
                                                  cfg.attention_heads)
        else:
            self.query_generator = self.cross_attention = None
        self.classifier = nn.Sequential(
            nn.Linear(c2 * 64, 1024),
            nn.LayerNorm(1024, eps=1e-5),
            nn.ReLU(),
            nn.Dropout(0.3),
            nn.Linear(1024, 512),
            nn.LayerNorm(512, eps=1e-5),
            nn.ReLU(),
            nn.Dropout(0.2),
            nn.Linear(512, 256),
            nn.LayerNorm(256, eps=1e-5),
            nn.ReLU(),
            nn.Dropout(0.1),
            nn.Linear(256, num_classes),
        )

    def forward(self, latents):
        x = latents
        if self.spatial_attention is not None:
            x = self.spatial_attention(x)
        conv, bn = self.feature_compress[0], self.feature_compress[1]
        x = _conv(conv, x)
        x = F.batch_norm(x.permute(0, 3, 1, 2), bn.running_mean,
                         bn.running_var, bn.weight, bn.bias, self.training,
                         bn.momentum, bn.eps).permute(0, 2, 3, 1)
        x = adaptive_avg_pool_nhwc(F.relu(x), (8, 8))
        if self.self_attention_post is not None:
            x = self.self_attention_post(x)
        flattened = _flatten_torch_order(x)
        if self.cross_attention is not None:
            query = self.query_generator(flattened)
            b, c = x.shape[0], x.shape[-1]
            attended = self.cross_attention(query, x.reshape(b, -1, c))
            # the reference mixes the *mean* of the attended query back in
            flattened = flattened + attended.mean(dim=1, keepdim=True)
        return self.classifier(flattened)


def create_attention_decoder(latent_channels: int, num_classes: int,
                             attention_config: Optional[dict] = None):
    """No attention config -> ``ClassificationDecoder``, else the attention
    head (the reference factory)."""
    if attention_config is None:
        return ClassificationDecoder(latent_channels, num_classes)
    cfg = AttentionDecoderConfig(
        use_spatial_attention=attention_config.get("use_spatial_attention",
                                                   True),
        use_self_attention=attention_config.get("use_self_attention", True),
        use_cross_attention=attention_config.get("use_cross_attention",
                                                 False),
        attention_heads=attention_config.get("attention_heads", 8),
        attention_dropout=attention_config.get("attention_dropout", 0.1),
    )
    return AttentionClassificationDecoder(latent_channels, num_classes, cfg)
