"""Building blocks of the FLUX AutoencoderKL encoder, NHWC in and out.

Counterpart of ``vae_tagger_tpu/nn/blocks.py``.  Module and parameter names
follow the diffusers state-dict keys
(``encoder.down_blocks.0.resnets.1.conv1.weight``,
``mid_block.attentions.0.to_out.0.weight``), and weights keep the torch
layouts (conv OIHW, linear (out, in)), so a diffusers checkpoint loads with
``load_state_dict`` 1:1.  Activations are NHWC tensors; parameters stay
fp32 and are cast to the activation dtype where a matmul or conv uses them.

Every encoder ResnetBlock runs both of its branches through the fused
``gn_silu_conv3x3`` (kernel B on the card); the attention's GroupNorm and
``conv_norm_out`` go through ``group_norm_silu`` (kernel A) and the
mid-block attention through kernel C.  With ``remat`` each ResnetBlock
and the attention run under ``torch.utils.checkpoint`` (non-reentrant):
the counterpart of ``nn.remat`` in the JAX package, O(block) activation
memory for a second forward in the backward.  ``Upsample`` and
``UpDecoderBlock`` wait for the decoder slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import spatial_single_head_attention
from ..ops.conv import conv2d_nhwc, gn_silu_conv3x3
from ..ops.normalization import group_norm_silu


def _call(module: nn.Module, x, remat: bool):
    """``module(x)``, under activation checkpointing when ``remat``."""
    if remat:
        return checkpoint(module, x, use_reentrant=False)
    return module(x)


def linear(module: nn.Linear, x):
    """``module`` applied in the dtype of x."""
    bias = None if module.bias is None else module.bias.to(x.dtype)
    return F.linear(x, module.weight.to(x.dtype), bias)


class GroupNorm(nn.Module):
    """GroupNorm over consecutive-channel groups, optionally fused with the
    following SiLU (kernel A on the card)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6,
                 with_silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.with_silu = with_silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm_silu(x, self.weight, self.bias,
                               num_groups=self.num_groups, eps=self.eps,
                               apply_silu=self.with_silu)


class Conv2D(nn.Module):
    """Conv with an OIHW ``weight`` and a ``bias``, applied to NHWC input
    (``F.conv2d``, as the JAX package leaves these convs to ``lax.conv``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def hwio(self):
        """The weight as the (kh, kw, Cin, Cout) view the fused op takes."""
        return self.weight.permute(2, 3, 1, 0)

    def forward(self, x):
        return conv2d_nhwc(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                           self.stride, self.padding)


class ResnetBlock(nn.Module):
    """GroupNorm -> SiLU -> Conv3x3, twice, plus the (1x1-projected)
    residual; both branches run fused (ops/conv.py::gn_silu_conv3x3)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(num_groups, in_channels, eps, with_silu=True)
        self.conv1 = Conv2D(in_channels, out_channels)
        self.norm2 = GroupNorm(num_groups, out_channels, eps, with_silu=True)
        self.conv2 = Conv2D(out_channels, out_channels)
        self.conv_shortcut = (Conv2D(in_channels, out_channels, 1, padding=0)
                              if in_channels != out_channels else None)

    def forward(self, x):
        n1, n2 = self.norm1, self.norm2
        h = gn_silu_conv3x3(x, n1.weight, n1.bias, self.conv1.hwio(),
                            self.conv1.bias, num_groups=n1.num_groups,
                            eps=n1.eps)
        sc = self.conv_shortcut
        return gn_silu_conv3x3(
            h, n2.weight, n2.bias, self.conv2.hwio(), self.conv2.bias,
            residual=x,
            shortcut_kernel=None if sc is None else sc.weight[:, :, 0, 0].t(),
            shortcut_bias=None if sc is None else sc.bias,
            num_groups=n2.num_groups, eps=n2.eps)


class Downsample(nn.Module):
    """Stride-2 3x3 conv after one pixel of zero padding on the right and
    bottom edges only (torch ``F.pad(x, (0, 1, 0, 1))`` + unpadded conv)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class VAEAttention(nn.Module):
    """Single-head spatial self-attention with residual (the mid block):
    GroupNorm (no SiLU), Q/K/V/out projections with bias, one head of dim
    == channels, fp32 softmax (kernel C on the card)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.group_norm = GroupNorm(num_groups, channels, eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        n, h, w, c = x.shape
        y = self.group_norm(x).reshape(n, h * w, c)
        o = spatial_single_head_attention(linear(self.to_q, y),
                                          linear(self.to_k, y),
                                          linear(self.to_v, y))
        return linear(self.to_out[0], o).reshape(n, h, w, c) + x


class MidBlock(nn.Module):
    """resnet -> (attention) -> resnet at the bottleneck."""

    def __init__(self, channels: int, num_groups: int = 32,
                 add_attention: bool = True, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, num_groups),
            ResnetBlock(channels, channels, num_groups),
        ])
        self.attentions = nn.ModuleList(
            [VAEAttention(channels, num_groups)] if add_attention else [])

    def forward(self, x):
        x = _call(self.resnets[0], x, self.remat)
        for attn in self.attentions:
            x = _call(attn, x, self.remat)
        return _call(self.resnets[1], x, self.remat)


class DownEncoderBlock(nn.Module):
    """``num_layers`` resnets, then an optional stride-2 downsample."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, add_downsample: bool = True,
                 num_groups: int = 32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels, out_channels,
                        num_groups)
            for i in range(num_layers)
        ])
        self.downsamplers = (nn.ModuleList([Downsample(out_channels)])
                             if add_downsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = _call(r, x, self.remat)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Deterministic fresh weights from a ``torch.Generator``: conv and
    linear weights lecun-normal (std 1/sqrt(fan_in), as the JAX package
    initializes them), biases zero, norms identity.  Running BatchNorm
    stats are left at (0, 1)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    for name, p in sorted(module.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() >= 2:
            fan_in = math.prod(p.shape[1:])
            w = torch.randn(p.shape, generator=g) / math.sqrt(fan_in)
            p.copy_(w.to(p))
        elif leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()
    return module
