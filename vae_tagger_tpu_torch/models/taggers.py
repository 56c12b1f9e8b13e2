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
``eval()`` mode dropout is off and BatchNorm reads its running stats.  In
``train()`` mode dropout draws from the ``generator`` passed to the
forward (the JAX package's explicit dropout key), and BatchNorm normalizes
with the batch statistics and updates its running statistics as flax's
``BatchNorm(momentum=0.9)`` does: with the *biased* batch variance.  Under
data parallelism (parallel/mesh.py) both see the global batch, as XLA's
SPMD step does: the dropout masks are this process's rows of the global
batch's draw, and the BatchNorm statistics are all-reduced (with their
gradient).

Each head has a compute ``dtype`` (fp32 by default; the policy's compute
dtype, bf16 under mixed precision, where the engine and the trainers build
it), with the semantics of a flax module's ``dtype``: every conv and
Linear casts its input and its fp32 parameters to it; the softmaxes run in
fp32 and are cast back; LayerNorm and BatchNorm take their statistics and
apply their affine in fp32 and return ``dtype``.  Parameters, their
gradients and the BatchNorm running statistics stay fp32.  In fp32 every
cast is the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import AttentionDecoderConfig
from ..ops.conv import conv2d_nhwc
from ..parallel.mesh import draw_global, global_sum, process_count
from ..ops.pooling import adaptive_avg_pool_nhwc, adaptive_max_pool_nhwc


def _flatten_torch_order(x):
    """(B, H, W, C) -> (B, C*H*W), channel-major like torch NCHW."""
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def _conv(conv: nn.Conv2d, x, dtype):
    """The conv in ``dtype``: input, weight and bias cast to it.  Below
    fp32 the bias is added after the conv, where flax rounds it (fp32
    keeps torch's fused form)."""
    x, w = x.to(dtype), conv.weight.to(dtype)
    if dtype == torch.float32 or conv.bias is None:
        return conv2d_nhwc(x, w, conv.bias, conv.stride, conv.padding)
    return (conv2d_nhwc(x, w, None, conv.stride, conv.padding)
            + conv.bias.to(dtype))


def _linear(layer: nn.Linear, x, dtype):
    """The Linear in ``dtype``, its bias added as in :func:`_conv`."""
    x, w = x.to(dtype), layer.weight.to(dtype)
    if dtype == torch.float32 or layer.bias is None:
        return F.linear(x, w, layer.bias)
    return x @ w.t() + layer.bias.to(dtype)


def _sigmoid(x):
    """jax.nn.sigmoid, 1 / (1 + exp(-x)) with each op rounded to x's dtype,
    below fp32 (fp32 keeps torch.sigmoid)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def _normalize(x, mean, var, weight, bias, eps, dtype):
    """flax's normalization of ``x`` by fp32 statistics: (x - mean) *
    (rsqrt(var + eps) * weight) + bias in fp32, cast to ``dtype``."""
    return ((x.float() - mean) * (torch.rsqrt(var + eps) * weight)
            + bias).to(dtype)


def _layer_norm(ln: nn.LayerNorm, x, dtype):
    """LayerNorm with its statistics and affine in fp32 (below fp32 as
    flax computes them: the variance as E[x^2] - E[x]^2), output in
    ``dtype``."""
    if dtype == torch.float32:
        return F.layer_norm(x.float(), ln.normalized_shape, ln.weight,
                            ln.bias, ln.eps)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return _normalize(xf, mean, var, ln.weight, ln.bias, ln.eps, dtype)


def _rand(shape, generator, device) -> torch.Tensor:
    """Uniform [0, 1) noise of ``shape`` from ``generator``."""
    return torch.rand(shape, generator=generator, device=device)


def dropout(x, p: float, training: bool, generator=None):
    """Inverted dropout whose mask is drawn from ``generator`` (the default
    generator when None), this process's rows of the global batch's draw;
    the identity outside training."""
    if not training or p == 0.0:
        return x
    keep = draw_global(lambda shape: _rand(shape, generator, x.device),
                       x.shape) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def _sequential(layers: nn.Sequential, x, dtype, generator=None):
    """``layers`` applied in order in ``dtype``, each ``nn.Dropout`` from
    ``generator``."""
    for layer in layers:
        if isinstance(layer, nn.Dropout):
            x = dropout(x, layer.p, layer.training, generator)
        elif isinstance(layer, nn.Linear):
            x = _linear(layer, x, dtype)
        elif isinstance(layer, nn.LayerNorm):
            x = _layer_norm(layer, x, dtype)
        elif isinstance(layer, nn.LeakyReLU) and dtype != torch.float32:
            # flax's where(x >= 0, x, slope * x), the slope in x's dtype
            slope = torch.tensor(layer.negative_slope, dtype=x.dtype)
            x = torch.where(x >= 0, x, slope * x)
        else:
            x = layer(x)
    return x


def _global_batch_stats(xf):
    """(mean, biased variance) per channel of an NHWC fp32 tensor over the
    global batch, two-pass, with their gradients."""
    count = xf.shape[0] * xf.shape[1] * xf.shape[2] * process_count()
    mean = global_sum(xf.sum(dim=(0, 1, 2))) / count
    var = global_sum((xf - mean).square().sum(dim=(0, 1, 2))) / count
    return mean, var


@torch.no_grad()
def _update_running(bn: nn.BatchNorm2d, mean, var):
    m = bn.momentum
    bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
    bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
    bn.num_batches_tracked += 1


def batch_norm_nhwc(bn: nn.BatchNorm2d, x, dtype=torch.float32):
    """BatchNorm over an NHWC tensor, its statistics and affine in fp32,
    output in ``dtype``.  In training it normalizes with the batch
    statistics (two-pass variance) and moves the running ones by
    ``bn.momentum`` toward the batch mean and the biased batch variance
    (flax's update; torch's own would take the unbiased variance).  Under
    data parallelism the statistics are the global batch's."""
    if bn.training and process_count() > 1:
        mean, var = _global_batch_stats(x.float())
        _update_running(bn, mean.detach(), var.detach())
        return _normalize(x, mean, var, bn.weight, bn.bias, bn.eps, dtype)
    if bn.training:
        var, mean = torch.var_mean(x.float(), dim=(0, 1, 2), correction=0)
        _update_running(bn, mean, var)
    if dtype != torch.float32:
        if not bn.training:
            mean, var = bn.running_mean, bn.running_var
        return _normalize(x, mean, var, bn.weight, bn.bias, bn.eps, dtype)
    running = (None, None) if bn.training else (bn.running_mean,
                                                bn.running_var)
    return F.batch_norm(x.float().permute(0, 3, 1, 2), *running, bn.weight,
                        bn.bias, bn.training, 0.0,
                        bn.eps).permute(0, 2, 3, 1)


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

    def forward(self, x, dtype=torch.float32, maps=None):
        """The gated map; ``maps`` (a dict), when given, receives the
        channel gate (B, 1, 1, C) and the spatial gate (B, H, W, 1)."""
        ca0, ca2 = self.channel_att[0], self.channel_att[2]

        def bottleneck(t):
            return _conv(ca2, F.relu(_conv(ca0, t, dtype)), dtype)

        channel_att = _sigmoid(
            bottleneck(adaptive_avg_pool_nhwc(x, 1))
            + bottleneck(adaptive_max_pool_nhwc(x, 1)))
        x = x * channel_att
        spatial = torch.cat([x.mean(dim=-1, keepdim=True),
                             x.amax(dim=-1, keepdim=True)], dim=-1)
        spatial_att = _sigmoid(_conv(self.spatial_att[0], spatial, dtype))
        if maps is not None:
            maps["channel_attention"] = channel_att
            maps["spatial_attention"] = spatial_att
        return x * spatial_att


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

    def forward(self, x, generator=None, dtype=torch.float32, maps=None):
        """``maps``, when given, receives the softmax weights before the
        dropout, (B, heads, S, S), under ``self_attention``."""
        b, h, w, c = x.shape
        s = h * w
        seq = x.reshape(b, s, c)
        y = _layer_norm(self.norm, seq, dtype)

        def heads(t):
            return t.reshape(b, s, self.num_heads, self.head_dim).transpose(
                1, 2)

        q, k, v = (heads(_linear(proj, y, dtype))
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        scores = q @ k.transpose(-2, -1) / (self.head_dim ** 0.5)
        weights = scores.float().softmax(dim=-1).to(q.dtype)
        if maps is not None:
            maps["self_attention"] = weights
        weights = dropout(weights, self.dropout.p, self.training, generator)
        out = (weights @ v).transpose(1, 2).reshape(b, s, c)
        return (_linear(self.out_proj, out, dtype) + seq).reshape(b, h, w, c)


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

    def forward(self, query, key_value, dtype=torch.float32, maps=None):
        """query (B, Qd), key_value (B, S, Kd); ``maps``, when given,
        receives the softmax weights (B, heads, 1, S) under
        ``cross_attention``."""
        b = query.shape[0]

        def heads(t):
            return t.reshape(b, -1, self.num_heads, self.head_dim).transpose(
                1, 2)

        q = heads(_linear(self.q_proj, query, dtype))
        k = heads(_linear(self.k_proj, key_value, dtype))
        v = heads(_linear(self.v_proj, key_value, dtype))
        scores = q @ k.transpose(-2, -1) / (self.head_dim ** 0.5)
        weights = scores.float().softmax(dim=-1).to(q.dtype)
        if maps is not None:
            maps["cross_attention"] = weights
        out = (weights @ v).transpose(1, 2).reshape(b, self.embed_dim)
        return _linear(self.out_proj, out, dtype) + query


class ClassificationDecoder(nn.Module):
    """MLP head: AdaptiveAvgPool(4,4) -> Linear 512 -> LN -> LeakyReLU(0.2)
    -> Dropout(0.3) -> Linear 256 -> LN -> LeakyReLU -> Dropout(0.2) ->
    logits."""

    def __init__(self, latent_channels: int, num_classes: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
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

    def forward(self, latents, generator=None):
        x = adaptive_avg_pool_nhwc(latents, (4, 4))
        return _sequential(self.classifier, _flatten_torch_order(x),
                           self.dtype, generator)


class AttentionClassificationDecoder(nn.Module):
    """The default tagger head: optional CBAM gate on the latent -> 3x3 conv
    C -> C/2 + BatchNorm + ReLU + AdaptiveAvgPool(8,8) -> optional MHSA over
    the 64 tokens -> 4-layer MLP -> logits, with an optional one-query
    cross-attention branch mixed into the flattened features."""

    def __init__(self, latent_channels: int, num_classes: int,
                 attention: AttentionDecoderConfig = AttentionDecoderConfig(),
                 dtype=torch.float32):
        super().__init__()
        cfg = attention
        self.config = cfg
        self.dtype = dtype
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

    def forward(self, latents, generator=None, maps=None):
        """Logits of NHWC ``latents``; ``maps`` (a dict), when given,
        receives the attention maps of :func:`get_attention_maps`."""
        dt = self.dtype
        x = latents
        if self.spatial_attention is not None:
            x = self.spatial_attention(x, dt, maps)
        x = _conv(self.feature_compress[0], x, dt)
        x = batch_norm_nhwc(self.feature_compress[1], x, dt)
        x = adaptive_avg_pool_nhwc(F.relu(x), (8, 8))
        if self.self_attention_post is not None:
            x = self.self_attention_post(x, generator, dt, maps)
        flattened = _flatten_torch_order(x)
        if self.cross_attention is not None:
            query = _linear(self.query_generator, flattened, dt)
            b, c = x.shape[0], x.shape[-1]
            attended = self.cross_attention(query, x.reshape(b, -1, c), dt,
                                            maps)
            # the reference mixes the *mean* of the attended query back in
            flattened = flattened + attended.mean(dim=1, keepdim=True)
        return _sequential(self.classifier, flattened, dt, generator)


@torch.no_grad()
def get_attention_maps(decoder: AttentionClassificationDecoder,
                       latents) -> dict:
    """The attention maps of one eval-mode forward of ``decoder`` (the
    counterpart of the JAX package's ``get_attention_maps``, which sows
    them): a dict without the keys of the branches the head disables, in
    the head's compute dtype,

      channel_attention: (B, 1, 1, C)     CBAM channel gate (sigmoid)
      spatial_attention: (B, H, W, 1)     CBAM spatial gate (sigmoid)
      self_attention:    (B, heads, S, S) MHSA softmax weights (pre-dropout)
      cross_attention:   (B, heads, 1, S) cross-attention weights

    The caller puts the head in eval mode."""
    maps = {}
    decoder(latents, maps=maps)
    return maps


def create_attention_decoder(latent_channels: int, num_classes: int,
                             attention_config: Optional[dict] = None,
                             dtype=torch.float32):
    """No attention config -> ``ClassificationDecoder``, else the attention
    head (the reference factory); ``dtype`` is the heads' compute dtype."""
    if attention_config is None:
        return ClassificationDecoder(latent_channels, num_classes, dtype)
    cfg = AttentionDecoderConfig(
        use_spatial_attention=attention_config.get("use_spatial_attention",
                                                   True),
        use_self_attention=attention_config.get("use_self_attention", True),
        use_cross_attention=attention_config.get("use_cross_attention",
                                                 False),
        attention_heads=attention_config.get("attention_heads", 8),
        attention_dropout=attention_config.get("attention_dropout", 0.1),
    )
    return AttentionClassificationDecoder(latent_channels, num_classes, cfg,
                                          dtype)
