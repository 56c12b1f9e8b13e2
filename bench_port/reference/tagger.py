"""The plain reference of the tagger heads: a frozen copy of
``tests/torch_oracle/taggers_torch.py``, an independent PyTorch rewrite of
spawner1145/vae-tagger ``modules.py`` (the attention decoder of
``modules.py:358-485``, built as ``create_attention_decoder``
``:731-748``).  NCHW, plain ``torch`` operations; it imports nothing of the
program.

Departures from the published description: none in these modules.  The
dropout layers are ``nn.Dropout``; a training reference that has to draw
the same masks as another implementation draws them itself (see
``bench_port/reference/train.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class SpatialAttentionOracle(nn.Module):
    def __init__(self, in_channels, reduction_ratio=8):
        super().__init__()
        self.channel_att = nn.Sequential(
            nn.Conv2d(in_channels, in_channels // reduction_ratio, 1, bias=False),
            nn.ReLU(),
            nn.Conv2d(in_channels // reduction_ratio, in_channels, 1, bias=False),
        )
        self.spatial_att = nn.Sequential(
            nn.Conv2d(2, 1, kernel_size=7, padding=3, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x):
        avg = self.channel_att(F.adaptive_avg_pool2d(x, 1))
        mx = self.channel_att(F.adaptive_max_pool2d(x, 1))
        x = x * torch.sigmoid(avg + mx)
        spatial = torch.cat([x.mean(dim=1, keepdim=True),
                             x.max(dim=1, keepdim=True).values], dim=1)
        return x * self.spatial_att(spatial)


class MHSAOracle(nn.Module):
    def __init__(self, embed_dim, num_heads=8, dropout=0.1):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.dropout = nn.Dropout(dropout)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x):
        b, c, h, w = x.shape
        s = h * w
        seq = x.view(b, c, s).transpose(1, 2)
        residual = seq
        y = self.norm(seq)

        def heads(t):
            return t.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.q_proj(y)), heads(self.k_proj(y)), heads(self.v_proj(y))
        scores = q @ k.transpose(-2, -1) / math.sqrt(self.head_dim)
        weights = self.dropout(scores.softmax(dim=-1))
        out = (weights @ v).transpose(1, 2).contiguous().view(b, s, c)
        out = self.out_proj(out) + residual
        return out.transpose(1, 2).view(b, c, h, w)


class CrossAttentionOracle(nn.Module):
    """1-query cross-attention with residual (modules.py:93-124 semantics)."""

    def __init__(self, query_dim, key_dim, embed_dim, num_heads=8):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = nn.Linear(query_dim, embed_dim)
        self.k_proj = nn.Linear(key_dim, embed_dim)
        self.v_proj = nn.Linear(key_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, query_dim)

    def forward(self, query, key_value):
        b = query.shape[0]

        def heads(t, s):
            return t.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)

        q = heads(self.q_proj(query).unsqueeze(1), 1)
        k = heads(self.k_proj(key_value), key_value.shape[1])
        v = heads(self.v_proj(key_value), key_value.shape[1])
        scores = q @ k.transpose(-2, -1) / math.sqrt(self.head_dim)
        out = (scores.softmax(dim=-1) @ v).transpose(1, 2).contiguous().view(
            b, self.embed_dim)
        return self.out_proj(out) + query


class ClassificationDecoderOracle(nn.Module):
    def __init__(self, latent_channels, num_classes):
        super().__init__()
        self.adaptive_pool = nn.AdaptiveAvgPool2d((4, 4))
        self.classifier = nn.Sequential(
            nn.Linear(latent_channels * 16, 512),
            nn.LayerNorm(512),
            nn.LeakyReLU(0.2),
            nn.Dropout(0.3),
            nn.Linear(512, 256),
            nn.LayerNorm(256),
            nn.LeakyReLU(0.2),
            nn.Dropout(0.2),
            nn.Linear(256, num_classes),
        )

    def forward(self, latents):
        x = self.adaptive_pool(latents)
        return self.classifier(x.reshape(x.size(0), -1))


class AttentionDecoderOracle(nn.Module):
    def __init__(self, latent_channels, num_classes, use_spatial=True,
                 use_self=True, heads=8, dropout=0.1):
        super().__init__()
        self.use_spatial = use_spatial
        self.use_self = use_self
        if use_spatial:
            self.spatial_attention = SpatialAttentionOracle(latent_channels)
        compressed = latent_channels // 2
        self.feature_compress = nn.Sequential(
            nn.Conv2d(latent_channels, compressed, 3, 1, 1),
            nn.BatchNorm2d(compressed),
            nn.ReLU(),
            nn.AdaptiveAvgPool2d((8, 8)),
        )
        if use_self:
            self.self_attention_post = MHSAOracle(compressed, heads, dropout)
        self.classifier = nn.Sequential(
            nn.Linear(compressed * 64, 1024),
            nn.LayerNorm(1024),
            nn.ReLU(),
            nn.Dropout(0.3),
            nn.Linear(1024, 512),
            nn.LayerNorm(512),
            nn.ReLU(),
            nn.Dropout(0.2),
            nn.Linear(512, 256),
            nn.LayerNorm(256),
            nn.ReLU(),
            nn.Dropout(0.1),
            nn.Linear(256, num_classes),
        )

    def forward(self, latents):
        x = latents
        if self.use_spatial:
            x = self.spatial_attention(x)
        x = self.feature_compress(x)
        if self.use_self:
            x = self.self_attention_post(x)
        return self.classifier(x.reshape(x.size(0), -1))
