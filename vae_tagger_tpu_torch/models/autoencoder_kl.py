"""The FLUX AutoencoderKL in PyTorch, NHWC.

Counterpart of ``vae_tagger_tpu/models/autoencoder_kl.py``: ``Encoder`` and
``Decoder``, the diagonal-Gaussian posterior (``from_moments`` with logvar
clamped to [-30, 20], ``mode``, ``sample`` from an explicit generator,
``kl``), ``AutoencoderKL.encode`` / ``decode`` with the optional 1x1
``quant_conv`` / ``post_quant_conv`` of SD-family VAEs, the training
forward (encode -> sample -> decode), ``encode_scaled`` and
``decode_scaled``.  Module names follow the diffusers keys, so a diffusers
checkpoint loads 1:1.  ``with_decoder=False`` builds the encode half alone
(``encoder.*``, ``quant_conv.*``): what the tagging engine and latent
extraction hold on the card.

``remat=True`` checkpoints every ResnetBlock and the mid-block attention
(``torch.utils.checkpoint``, the JAX package's ``nn.remat``).

``encode`` and ``decode`` take a :class:`~..parallel.spatial.SpatialMesh`
of one data row (``spatial=``): the VAE body then runs on height slabs,
one a device of the mesh (``conv_in`` through the mid block,
``conv_norm_out``, ``conv_out`` and ``quant_conv``; the decoder's body
after ``post_quant_conv``), and the moments or the image are gathered
back to the input's device, where everything after them runs as it does
unsharded.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..core.config import VAEConfig
from ..parallel.mesh import draw_global
from ..parallel.spatial import gather_height, shard_height
from ..nn.blocks import (
    Conv2D,
    DownEncoderBlock,
    GroupNorm,
    MidBlock,
    UpDecoderBlock,
)


def _randn(shape, generator, device) -> torch.Tensor:
    """Standard normal fp32 noise of ``shape`` from ``generator``."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


@dataclasses.dataclass
class DiagonalGaussian:
    """Diagonal Gaussian posterior over NHWC latents (diffusers
    ``DiagonalGaussianDistribution``): logvar clamped to [-30, 20].
    ``parts`` is the number of equal blocks the batch stacks (3 for the
    anchor/positive/negative stack), which tells a data-parallel draw
    which rows of the global batch's noise are this process's."""

    mean: torch.Tensor    # (B, h, w, C)
    logvar: torch.Tensor  # (B, h, w, C)
    parts: int = 1

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=-1)
        return cls(mean=mean, logvar=logvar.clamp(-30.0, 20.0))

    def mode(self) -> torch.Tensor:
        return self.mean

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """mean + exp(logvar / 2) * eps, eps ~ N(0, I) from ``generator``
        (on the tensors' device); under data parallelism eps is this
        process's rows of the global batch's draw."""
        eps = draw_global(
            lambda shape: _randn(shape, generator, self.mean.device),
            self.mean.shape, self.parts)
        return self.mean + torch.exp(0.5 * self.logvar) * eps.to(
            self.mean.dtype)

    def kl(self) -> torch.Tensor:
        """Per-sample KL(q || N(0, I)) summed over (h, w, C) -> (B,)."""
        m, lv = self.mean.float(), self.logvar.float()
        return 0.5 * (m.square() + lv.exp() - 1.0 - lv).sum(dim=(1, 2, 3))


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig, remat: bool = False):
        super().__init__()
        cfg = config
        g = cfg.norm_num_groups
        ch = cfg.block_out_channels[0]
        self.conv_in = Conv2D(cfg.in_channels, ch)
        blocks = []
        for i, out_ch in enumerate(cfg.block_out_channels):
            blocks.append(DownEncoderBlock(
                ch, out_ch, cfg.layers_per_block,
                add_downsample=i < len(cfg.block_out_channels) - 1,
                num_groups=g, remat=remat))
            ch = out_ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(ch, g, cfg.mid_block_add_attention, remat)
        self.conv_norm_out = GroupNorm(g, ch, with_silu=True)
        self.conv_out = Conv2D(ch, 2 * cfg.latent_channels)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))  # (B, h, w, 2*latent)

    def forward_slabs(self, xs):
        xs = self.conv_in.forward_slabs(xs)
        for block in self.down_blocks:
            xs = block.forward_slabs(xs)
        xs = self.mid_block.forward_slabs(xs)
        return self.conv_out.forward_slabs(self.conv_norm_out.forward_slabs(xs))


class Decoder(nn.Module):
    """conv_in -> mid block -> up blocks (``layers_per_block + 1`` resnets
    each, nearest-2x upsample after all but the last) -> GN+SiLU ->
    conv_out, over the reversed channel list."""

    def __init__(self, config: VAEConfig, remat: bool = False):
        super().__init__()
        cfg = config
        g = cfg.norm_num_groups
        channels = list(reversed(cfg.block_out_channels))
        ch = channels[0]
        self.conv_in = Conv2D(cfg.latent_channels, ch)
        self.mid_block = MidBlock(ch, g, cfg.mid_block_add_attention, remat)
        blocks = []
        for i, out_ch in enumerate(channels):
            blocks.append(UpDecoderBlock(
                ch, out_ch, cfg.layers_per_block + 1,
                add_upsample=i < len(channels) - 1, num_groups=g,
                remat=remat))
            ch = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, ch, with_silu=True)
        self.conv_out = Conv2D(ch, cfg.out_channels)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))

    def forward_slabs(self, zs):
        xs = self.mid_block.forward_slabs(self.conv_in.forward_slabs(zs))
        for block in self.up_blocks:
            xs = block.forward_slabs(xs)
        return self.conv_out.forward_slabs(self.conv_norm_out.forward_slabs(xs))


class AutoencoderKL(nn.Module):
    """The VAE: ``encoder`` (+ ``quant_conv``) and, with ``with_decoder``,
    ``decoder`` (+ ``post_quant_conv``)."""

    def __init__(self, config: VAEConfig, remat: bool = False,
                 with_decoder: bool = False):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, remat)
        self.quant_conv = (
            Conv2D(2 * config.latent_channels, 2 * config.latent_channels, 1,
                   padding=0) if config.use_quant_conv else None)
        self.decoder = Decoder(config, remat) if with_decoder else None
        self.post_quant_conv = (
            Conv2D(config.latent_channels, config.latent_channels, 1,
                   padding=0)
            if with_decoder and config.use_post_quant_conv else None)

    def encode(self, x, spatial=None) -> DiagonalGaussian:
        """NHWC pixels in [-1, 1], in the compute dtype -> posterior (fp32);
        height-sharded over ``spatial`` (a one-row SpatialMesh) when it has
        more than one device."""
        if spatial is not None and spatial.shards > 1:
            spatial.check_height(x.shape[1], self.config.downsample_factor)
            xs = self.encoder.forward_slabs(shard_height(x, spatial.devices))
            if self.quant_conv is not None:
                xs = self.quant_conv.forward_slabs(xs)
            moments = gather_height(xs, x.device)
        else:
            moments = self.encoder(x)
            if self.quant_conv is not None:
                moments = self.quant_conv(moments)
        return DiagonalGaussian.from_moments(moments.float())

    def decode(self, z, dtype: torch.dtype = torch.float32,
               spatial=None) -> torch.Tensor:
        """NHWC latents -> reconstruction (fp32), computed in ``dtype``;
        the decoder's body height-sharded over ``spatial`` when it has more
        than one device."""
        if self.decoder is None:
            raise RuntimeError("this AutoencoderKL was built without its "
                               "decoder (with_decoder=False)")
        z = z.to(dtype)
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        if spatial is not None and spatial.shards > 1:
            xs = self.decoder.forward_slabs(shard_height(z, spatial.devices))
            return gather_height(xs, z.device).float()
        return self.decoder(z).float()

    def scale_latents(self, mean: torch.Tensor) -> torch.Tensor:
        """The latents the tagger head reads (:func:`encode_scaled`):
        ``mean * scaling_factor + shift_factor``."""
        return encode_scaled(mean, self.config)

    def forward(self, x, generator: torch.Generator):
        """The training forward: (reconstruction of a posterior draw from
        ``generator``, posterior), in the dtype of x."""
        posterior = self.encode(x)
        return self.decode(posterior.sample(generator), x.dtype), posterior


def encode_scaled(posterior_mode: torch.Tensor,
                  config: VAEConfig) -> torch.Tensor:
    """latent * scaling_factor + shift_factor (the diffusers wrapper's
    encode transform)."""
    return posterior_mode * config.scaling_factor + config.shift_factor


def decode_scaled(z: torch.Tensor, config: VAEConfig) -> torch.Tensor:
    """The inverse of :func:`encode_scaled`, applied before decoding."""
    return (z - config.shift_factor) / config.scaling_factor
