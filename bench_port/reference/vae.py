"""The plain reference of the FLUX VAE: a frozen copy of
``tests/torch_oracle/vae_torch.py`` (an independent PyTorch rewrite of the
diffusers ``AutoencoderKL`` from its published architecture), kept here so
that later changes to the program or its tests cannot move the yardstick.
NCHW, plain ``torch`` operations, fp32 unless the caller casts it; it
imports nothing of the program.

Departures from the published description (diffusers ``AutoencoderKL``,
black-forest-labs/FLUX.1-dev ``vae/config.json``): none in the encoder.
The attention block computes its softmax in fp32 whatever the module's
dtype, as diffusers' attention processor upcasts it.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, groups=32, eps=1e-6):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (
            nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        )

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """Single-head spatial self-attention with residual (VAE mid-block)."""

    def __init__(self, channels, groups=32, eps=1e-6):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        residual = x
        b, c, h, w = x.shape
        y = self.group_norm(x).view(b, c, h * w).transpose(1, 2)  # (B, S, C)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        scores = q @ k.transpose(-2, -1) / math.sqrt(c)
        weights = scores.float().softmax(dim=-1).to(v.dtype)
        out = self.to_out[0](weights @ v)
        out = out.transpose(1, 2).view(b, c, h, w)
        return out + residual


class MidBlock(nn.Module):
    def __init__(self, channels, groups=32, add_attention=True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, groups),
            ResnetBlock2D(channels, channels, groups),
        ])
        self.attentions = nn.ModuleList(
            [AttentionBlock(channels, groups)] if add_attention else [])

    def forward(self, x):
        x = self.resnets[0](x)
        if self.attentions:
            x = self.attentions[0](x)
        return self.resnets[1](x)


class DownBlock(nn.Module):
    def __init__(self, in_ch, out_ch, num_layers, add_downsample, groups=32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, groups)
            for i in range(num_layers)
        ])
        if add_downsample:
            conv = nn.Conv2d(out_ch, out_ch, 3, stride=2, padding=0)
            down = nn.Module()
            down.conv = conv
            self.downsamplers = nn.ModuleList([down])
        else:
            self.downsamplers = None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = F.pad(x, (0, 1, 0, 1))
            x = self.downsamplers[0].conv(x)
        return x


class UpBlock(nn.Module):
    def __init__(self, in_ch, out_ch, num_layers, add_upsample, groups=32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, groups)
            for i in range(num_layers)
        ])
        if add_upsample:
            conv = nn.Conv2d(out_ch, out_ch, 3, padding=1)
            up = nn.Module()
            up.conv = conv
            self.upsamplers = nn.ModuleList([up])
        else:
            self.upsamplers = None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = self.upsamplers[0].conv(x)
        return x


class Encoder(nn.Module):
    def __init__(self, in_channels, block_out_channels, layers_per_block,
                 latent_channels, groups, add_attention=True):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, block_out_channels[0], 3, padding=1)
        blocks = []
        ch = block_out_channels[0]
        for i, out_ch in enumerate(block_out_channels):
            blocks.append(DownBlock(
                ch, out_ch, layers_per_block,
                add_downsample=i < len(block_out_channels) - 1, groups=groups))
            ch = out_ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(ch, groups, add_attention)
        self.conv_norm_out = nn.GroupNorm(groups, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for b in self.down_blocks:
            x = b(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, out_channels, block_out_channels, layers_per_block,
                 latent_channels, groups, add_attention=True):
        super().__init__()
        reversed_ch = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, reversed_ch[0], 3, padding=1)
        self.mid_block = MidBlock(reversed_ch[0], groups, add_attention)
        blocks = []
        ch = reversed_ch[0]
        for i, out_ch in enumerate(reversed_ch):
            blocks.append(UpBlock(
                ch, out_ch, layers_per_block + 1,
                add_upsample=i < len(reversed_ch) - 1, groups=groups))
            ch = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(groups, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, out_channels, 3, padding=1)

    def forward(self, z):
        x = self.conv_in(z)
        x = self.mid_block(x)
        for b in self.up_blocks:
            x = b(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKLOracle(nn.Module):
    def __init__(self, in_channels=3, out_channels=3,
                 block_out_channels=(128, 256, 512, 512), layers_per_block=2,
                 latent_channels=16, norm_num_groups=32, add_attention=True,
                 use_quant_conv=False, use_post_quant_conv=False):
        super().__init__()
        self.encoder = Encoder(in_channels, block_out_channels,
                               layers_per_block, latent_channels,
                               norm_num_groups, add_attention)
        self.decoder = Decoder(out_channels, block_out_channels,
                               layers_per_block, latent_channels,
                               norm_num_groups, add_attention)
        # SD-family 1x1 latent convs (diffusers AutoencoderKL defaults;
        # the FLUX config disables both)
        self.quant_conv = (nn.Conv2d(2 * latent_channels, 2 * latent_channels,
                                     1) if use_quant_conv else None)
        self.post_quant_conv = (nn.Conv2d(latent_channels, latent_channels, 1)
                                if use_post_quant_conv else None)

    def encode_moments(self, x):
        moments = self.encoder(x)
        if self.quant_conv is not None:
            moments = self.quant_conv(moments)
        return moments

    def decode(self, z):
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)
