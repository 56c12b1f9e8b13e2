"""The plain reference of the Wan 2.1 VAE's encoder: a frozen copy of
``tests/torch_oracle/wan_vae_torch.py`` (an independent PyTorch rewrite of
the diffusers ``AutoencoderKLWan`` from its published architecture), kept
here so that later changes to the program or its tests cannot move the
yardstick.  It keeps the published 3-D form: (N, C, T, H, W) clips, every
causal conv ``F.conv3d`` on its input padded with two zero frames in front,
the RMS norm ``F.normalize(x, dim=1) * sqrt(C) * gamma``, the attention
written out with its softmax in fp32, ``quant_conv`` after the encoder.
Parameter names and shapes are diffusers' (5-D conv kernels, ``gamma``
(C, 1, 1[, 1]), ``time_conv`` in each ``downsample3d``).  fp32 unless the
caller casts it; it imports nothing of the program.

Departures from the published encoder, each exact on one frame (T = 1),
which is what this system encodes: ``encode_moments`` runs the first
frame's chunk with an empty feature cache, as ``AutoencoderKLWan._encode``
does; ``time_conv`` is built and never run (``downsample3d`` applies it
from the second chunk on); dropout (0 as published) is left out.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class CausalConv3d(nn.Conv3d):
    """A conv over (N, C, T, H, W) that sees no later frame: two zero frames
    in front (for a kernel 3 deep), ``padding`` on H and W."""

    def __init__(self, in_ch, out_ch, k, padding=0):
        super().__init__(in_ch, out_ch, k, padding=0)
        self.causal = (padding, padding, padding, padding, 2 * padding, 0)

    def forward(self, x):
        return super().forward(F.pad(x, self.causal))


class RMSNorm(nn.Module):
    """F.normalize over the channels, times sqrt(C) and gamma; no bias."""

    def __init__(self, dim, images=True):
        super().__init__()
        shape = (dim, 1, 1) if images else (dim, 1, 1, 1)
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(shape))

    def forward(self, x):
        return F.normalize(x, dim=1) * self.scale * self.gamma


class ResidualBlock(nn.Module):
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.norm1 = RMSNorm(in_dim, images=False)
        self.conv1 = CausalConv3d(in_dim, out_dim, 3, padding=1)
        self.norm2 = RMSNorm(out_dim, images=False)
        self.conv2 = CausalConv3d(out_dim, out_dim, 3, padding=1)
        self.conv_shortcut = (CausalConv3d(in_dim, out_dim, 1)
                              if in_dim != out_dim else None)

    def forward(self, x):
        h = x if self.conv_shortcut is None else self.conv_shortcut(x)
        x = self.conv1(F.silu(self.norm1(x)))
        x = self.conv2(F.silu(self.norm2(x)))
        return x + h


class AttentionBlock(nn.Module):
    """Single-head self-attention over one frame's H x W tokens."""

    def __init__(self, dim):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1)
        self.proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        identity = x
        b, c, t, h, w = x.shape
        y = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
        qkv = self.to_qkv(self.norm(y)).reshape(b * t, 3 * c, h * w)
        q, k, v = qkv.transpose(1, 2).chunk(3, dim=-1)  # (bt, S, C) each
        scores = q @ k.transpose(-2, -1) / math.sqrt(c)
        weights = scores.float().softmax(dim=-1).to(v.dtype)
        o = (weights @ v).transpose(1, 2).reshape(b * t, c, h, w)
        o = self.proj(o).reshape(b, t, c, h, w).permute(0, 2, 1, 3, 4)
        return o + identity


class Resample(nn.Module):
    """The encoder's downsample: ZeroPad2d((0, 1, 0, 1)) and a stride-2 3x3
    conv on each frame; ``downsample3d`` also holds ``time_conv``."""

    def __init__(self, dim, temporal):
        super().__init__()
        self.resample = nn.Sequential(nn.ZeroPad2d((0, 1, 0, 1)),
                                      nn.Conv2d(dim, dim, 3, stride=2))
        if temporal:
            self.time_conv = CausalConv3d(dim, dim, (3, 1, 1))

    def forward(self, x):
        b, c, t, h, w = x.shape
        y = self.resample(x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w))
        return y.reshape(b, t, c, *y.shape[-2:]).permute(0, 2, 1, 3, 4)


class MidBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.resnets = nn.ModuleList([ResidualBlock(dim, dim),
                                      ResidualBlock(dim, dim)])
        self.attentions = nn.ModuleList([AttentionBlock(dim)])

    def forward(self, x):
        x = self.resnets[0](x)
        return self.resnets[1](self.attentions[0](x))


class Encoder3d(nn.Module):
    def __init__(self, dim, z_dim, dim_mult, num_res_blocks, attn_scales,
                 temperal_downsample):
        super().__init__()
        dims = [dim * u for u in [1] + list(dim_mult)]
        scale = 1.0
        self.conv_in = CausalConv3d(3, dims[0], 3, padding=1)
        blocks = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(num_res_blocks):
                blocks.append(ResidualBlock(in_dim, out_dim))
                if scale in attn_scales:
                    blocks.append(AttentionBlock(out_dim))
                in_dim = out_dim
            if i != len(dim_mult) - 1:
                blocks.append(Resample(out_dim, temperal_downsample[i]))
                scale /= 2.0
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(out_dim)
        self.norm_out = RMSNorm(out_dim, images=False)
        self.conv_out = CausalConv3d(out_dim, z_dim, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class WanVAEOracle(nn.Module):
    """The encoder and ``quant_conv`` of ``AutoencoderKLWan``."""

    def __init__(self, base_dim=96, z_dim=16, dim_mult=(1, 2, 4, 4),
                 num_res_blocks=2, attn_scales=(),
                 temperal_downsample=(False, True, True), latents_mean=None,
                 latents_std=None):
        super().__init__()
        self.z_dim = z_dim
        self.encoder = Encoder3d(base_dim, 2 * z_dim, dim_mult,
                                 num_res_blocks, attn_scales,
                                 temperal_downsample)
        self.quant_conv = CausalConv3d(2 * z_dim, 2 * z_dim, 1)
        self.latents_mean = list(latents_mean or [0.0] * z_dim)
        self.latents_std = list(latents_std or [1.0] * z_dim)

    def encode_moments(self, x):
        """NCHW images in [-1, 1] -> (N, 2 z_dim, h, w) moments: the mean,
        then the log-variance (unclamped)."""
        return self.quant_conv(self.encoder(x[:, :, None]))[:, :, 0]

    def latent_normalize(self, mean):
        """(mean - latents_mean_c) / latents_std_c over dim 1 of NCHW."""
        m = torch.tensor(self.latents_mean, dtype=mean.dtype,
                         device=mean.device).view(1, -1, 1, 1)
        s = torch.tensor(self.latents_std, dtype=mean.dtype,
                         device=mean.device).view(1, -1, 1, 1)
        return (mean - m) / s
