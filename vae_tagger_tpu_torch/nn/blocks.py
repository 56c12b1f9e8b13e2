"""Building blocks of the FLUX AutoencoderKL and of the Wan VAE's encoder,
NHWC in and out.

Counterpart of ``vae_tagger_tpu/nn/blocks.py``.  Module and parameter names
follow the diffusers state-dict keys
(``encoder.down_blocks.0.resnets.1.conv1.weight``,
``mid_block.attentions.0.to_out.0.weight``), and weights keep the torch
layouts (conv OIHW, linear (out, in)), so a diffusers checkpoint loads with
``load_state_dict`` 1:1.  Activations are NHWC tensors; parameters stay
fp32 and are cast to the activation dtype where a matmul or conv uses them.

Every ResnetBlock, of the encoder and of the decoder, runs both of its
branches through the fused ``gn_silu_conv3x3`` (kernel B on the card); the
attention's GroupNorm and ``conv_norm_out`` go through ``group_norm_silu``
(kernel A) and the mid-block attention through kernel C.  The decoder's
``Upsample`` is a nearest 2x repeat and a plain 3x3 conv (``F.conv2d``,
outside any TPU kernel in the JAX package too).  With ``remat`` each
ResnetBlock and the attention run under ``torch.utils.checkpoint``
(non-reentrant): the counterpart of ``nn.remat`` in the JAX package,
O(block) activation memory for a second forward in the backward.

Every block also has a slab form, ``forward_slabs``: a list of NHWC
height slabs in, one a device, the same list out (parallel/spatial.py);
what the unsharded ``forward`` computes is unchanged.  The 3x3 convs and the fused convs
run on each slab extended by one halo row from each neighbour, and the
output rows of the halo are dropped; every GroupNorm (the fused convs'
prologues included) is fed the whole image's statistics, combined from
each slab's own rows; the stride-2 ``Downsample`` takes one halo row from
below, its zero row on the last slab only; the mid-block attention runs
each slab's queries against the gathered keys and values.  A slab's
parameters are read on its device through ``.to``.

The Wan VAE's encoder (diffusers ``AutoencoderKLWan``, one frame) has its
own blocks at the end of the module: :class:`RMSNorm` (``gamma`` (C,), the
per-pixel RMS norm), :class:`WanResidualBlock` (both branches through the
fused ``rms_silu_conv3x3``, kernel B' in its RMS mode on the card),
:class:`WanAttentionBlock` (RMS norm, a 1x1 ``to_qkv``, kernel C at head
width = channels, a 1x1 ``proj``) and :class:`WanResample` (the stride-2
downsample).  Their causal 3x3x3 convs hold only the last temporal tap,
the one that multiplies the first frame (models/autoencoder_kl_wan.py);
they have no slab form.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (
    spatial_single_head_attention,
    spatial_single_head_attention_sharded,
)
from ..ops.conv import (
    conv2d_nhwc,
    gn_silu_conv3x3,
    gn_silu_conv3x3_from_stats,
    rms_silu_conv3x3,
)
from ..ops.normalization import (
    group_norm_silu,
    group_norm_silu_from_stats,
    rms_norm_silu,
)
from ..parallel import spatial


def _call(module: nn.Module, x, remat: bool):
    """``module(x)``, under activation checkpointing when ``remat``."""
    if remat:
        return checkpoint(module, x, use_reentrant=False)
    return module(x)


def _call_slabs(module: nn.Module, xs: list, remat: bool) -> list:
    """``module.forward_slabs(xs)``, under activation checkpointing when
    ``remat`` (no RNG state is kept: the blocks draw nothing)."""
    if remat:
        return list(checkpoint(
            lambda *slabs: tuple(module.forward_slabs(list(slabs))), *xs,
            use_reentrant=False, preserve_rng_state=False))
    return module.forward_slabs(xs)


def _on(t, x):
    """Parameter ``t`` on the device of activation x (itself when it is
    already there)."""
    return t.to(x.device)


def linear(module: nn.Linear, x):
    """``module`` applied in the dtype of x, on x's device."""
    bias = (None if module.bias is None
            else module.bias.to(x.device, x.dtype))
    return F.linear(x, module.weight.to(x.device, x.dtype), bias)


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

    def forward_slabs(self, xs):
        stats = spatial.global_group_stats(xs, self.num_groups)
        return [group_norm_silu_from_stats(
            x, mean, meansq, _on(self.weight, x), _on(self.bias, x),
            eps=self.eps, apply_silu=self.with_silu)
            for x, (mean, meansq) in zip(xs, stats)]


class Conv2D(nn.Module):
    """Conv with an OIHW ``weight`` and a ``bias``, applied to NHWC input
    on its device (``F.conv2d``, as the JAX package leaves these convs to
    ``lax.conv``)."""

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
        return conv2d_nhwc(x, self.weight.to(x.device, x.dtype),
                           self.bias.to(x.device, x.dtype), self.stride,
                           self.padding)

    def forward_slabs(self, xs):
        """1x1: each slab alone; 3x3 (stride 1, SAME): each slab with a
        halo row from each neighbour, the halo's output rows dropped."""
        k = self.weight.shape[-1]
        if k == 1 and self.stride == 1 and self.padding == 0:
            return [self(x) for x in xs]
        if k != 3 or self.stride != 1 or self.padding != 1:
            raise ValueError(f"no slab form for a {k}x{k} conv with stride "
                             f"{self.stride}, padding {self.padding}")
        exts, tops = spatial.halo(xs, 1, 1)
        return spatial.crop([self(e) for e in exts], tops, xs[0].shape[1])


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

    def forward_slabs(self, xs):
        """Both fused convs on halo-extended slabs, their prologues fed the
        whole image's statistics; the residual (or its shortcut's input)
        is the first conv's extended input, over the same rows."""
        n1, n2, sc = self.norm1, self.norm2, self.conv_shortcut
        rows = xs[0].shape[1]
        ext_x, tops = spatial.halo(xs, 1, 1)
        hs = spatial.crop([
            gn_silu_conv3x3_from_stats(
                e, mean, meansq, _on(n1.weight, e), _on(n1.bias, e),
                _on(self.conv1.hwio(), e), _on(self.conv1.bias, e),
                eps=n1.eps)
            for e, (mean, meansq) in zip(
                ext_x, spatial.global_group_stats(xs, n1.num_groups))],
            tops, rows)
        ext_h, _ = spatial.halo(hs, 1, 1)
        outs = [
            gn_silu_conv3x3_from_stats(
                e, mean, meansq, _on(n2.weight, e), _on(n2.bias, e),
                _on(self.conv2.hwio(), e), _on(self.conv2.bias, e),
                residual=r,
                shortcut_kernel=(None if sc is None
                                 else _on(sc.weight[:, :, 0, 0].t(), e)),
                shortcut_bias=None if sc is None else _on(sc.bias, e),
                eps=n2.eps)
            for e, r, (mean, meansq) in zip(
                ext_h, ext_x, spatial.global_group_stats(hs, n2.num_groups))]
        return spatial.crop(outs, tops, rows)


class Downsample(nn.Module):
    """Stride-2 3x3 conv after one pixel of zero padding on the right and
    bottom edges only (torch ``F.pad(x, (0, 1, 0, 1))`` + unpadded conv)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))

    def forward_slabs(self, xs):
        """Each slab (of even height) with one halo row from below, the zero
        row on the last slab only, and the zero column on the right."""
        exts, _ = spatial.halo(xs, 0, 1)
        last = len(xs) - 1
        return [self.conv(F.pad(e, (0, 0, 0, 1, 0, int(i == last))))
                for i, e in enumerate(exts)]


class Upsample(nn.Module):
    """Nearest-neighbour 2x, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2D(channels, channels)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x)

    def forward_slabs(self, xs):
        return self.conv.forward_slabs(
            [x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
             for x in xs])


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

    def forward_slabs(self, xs):
        """Each slab's queries against every slab's keys and values."""
        ys = [y.reshape(y.shape[0], -1, y.shape[-1])
              for y in self.group_norm.forward_slabs(xs)]
        os = spatial_single_head_attention_sharded(
            [linear(self.to_q, y) for y in ys],
            [linear(self.to_k, y) for y in ys],
            [linear(self.to_v, y) for y in ys])
        return [linear(self.to_out[0], o).reshape(x.shape) + x
                for o, x in zip(os, xs)]


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

    def forward_slabs(self, xs):
        xs = _call_slabs(self.resnets[0], xs, self.remat)
        for attn in self.attentions:
            xs = _call_slabs(attn, xs, self.remat)
        return _call_slabs(self.resnets[1], xs, self.remat)


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

    def forward_slabs(self, xs):
        for r in self.resnets:
            xs = _call_slabs(r, xs, self.remat)
        if self.downsamplers is not None:
            xs = self.downsamplers[0].forward_slabs(xs)
        return xs


class UpDecoderBlock(nn.Module):
    """``num_layers`` resnets (``layers_per_block + 1`` in the decoder),
    then an optional nearest-2x upsample."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 3, add_upsample: bool = True,
                 num_groups: int = 32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels, out_channels,
                        num_groups)
            for i in range(num_layers)
        ])
        self.upsamplers = (nn.ModuleList([Upsample(out_channels)])
                           if add_upsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = _call(r, x, self.remat)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x

    def forward_slabs(self, xs):
        for r in self.resnets:
            xs = _call_slabs(r, xs, self.remat)
        if self.upsamplers is not None:
            xs = self.upsamplers[0].forward_slabs(xs)
        return xs


class RMSNorm(nn.Module):
    """The Wan VAE's RMS norm over the channels of each pixel,
    ``x / max(||x||, 1e-12) * sqrt(C) * gamma`` (no bias), optionally
    followed by SiLU (the RMS stats and apply passes on the card)."""

    def __init__(self, channels: int, with_silu: bool = False):
        super().__init__()
        self.with_silu = with_silu
        self.gamma = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        return rms_norm_silu(x, self.gamma, apply_silu=self.with_silu)


class WanResidualBlock(nn.Module):
    """RMS norm -> SiLU -> conv3x3, twice, plus the (1x1-projected)
    residual; both branches run fused (ops/conv.py::rms_silu_conv3x3).
    Dropout (0 in the published config) is left out: the encoder runs in
    eval mode."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = RMSNorm(in_channels, with_silu=True)
        self.conv1 = Conv2D(in_channels, out_channels)
        self.norm2 = RMSNorm(out_channels, with_silu=True)
        self.conv2 = Conv2D(out_channels, out_channels)
        self.conv_shortcut = (Conv2D(in_channels, out_channels, 1, padding=0)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = rms_silu_conv3x3(x, self.norm1.gamma, self.conv1.hwio(),
                             self.conv1.bias)
        sc = self.conv_shortcut
        return rms_silu_conv3x3(
            h, self.norm2.gamma, self.conv2.hwio(), self.conv2.bias,
            residual=x,
            shortcut_kernel=None if sc is None else sc.weight[:, :, 0, 0].t(),
            shortcut_bias=None if sc is None else sc.bias)


class WanAttentionBlock(nn.Module):
    """Single-head spatial self-attention with residual (the Wan VAE's mid
    block): RMS norm (no SiLU), a 1x1 ``to_qkv`` (C -> 3C: q, k, v in that
    order of channels), one head of dim == channels (kernel C on the
    card), a 1x1 ``proj``."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = RMSNorm(channels)
        self.to_qkv = Conv2D(channels, 3 * channels, 1, padding=0)
        self.proj = Conv2D(channels, channels, 1, padding=0)

    @staticmethod
    def _pointwise(conv: Conv2D, x):
        """A 1x1 conv as a matmul over the channels, in x's dtype."""
        w = conv.weight[:, :, 0, 0].to(x.device, x.dtype)
        return F.linear(x, w, conv.bias.to(x.device, x.dtype))

    def forward(self, x):
        n, h, w, c = x.shape
        qkv = self._pointwise(self.to_qkv, self.norm(x).reshape(n, h * w, c))
        q, k, v = qkv.chunk(3, dim=-1)
        o = spatial_single_head_attention(q, k, v)
        return self._pointwise(self.proj, o).reshape(n, h, w, c) + x


class WanResample(nn.Module):
    """The Wan encoder's spatial downsample: one column and row of zeros on
    the right and bottom, then a stride-2 3x3 conv (``resample.1``; index
    0 is the padding, which holds no weight).  ``downsample3d``'s
    ``time_conv`` never runs on a first frame and is not built."""

    def __init__(self, channels: int):
        super().__init__()
        self.resample = nn.ModuleList([
            nn.Identity(), Conv2D(channels, channels, 3, stride=2, padding=0)])

    def forward(self, x):
        return self.resample[1](F.pad(x, (0, 0, 0, 1, 0, 1)))


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
        elif leaf in ("weight", "gamma"):  # a norm's scale
            p.fill_(1.0)
        else:
            p.zero_()
    return module
