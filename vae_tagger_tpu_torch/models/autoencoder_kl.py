"""The FLUX AutoencoderKL encoder in PyTorch, NHWC.

Counterpart of ``vae_tagger_tpu/models/autoencoder_kl.py`` for the encode
and training paths: ``Encoder``, the diagonal-Gaussian posterior
(``from_moments`` with logvar clamped to [-30, 20], ``mode``, ``sample``
from an explicit generator, ``kl``), ``AutoencoderKL.encode`` with the
optional 1x1 ``quant_conv`` of SD-family VAEs, and ``encode_scaled``.
Module names follow the diffusers keys, so ``encoder.*`` and
``quant_conv.*`` of a diffusers checkpoint load 1:1.  The decoder waits for
its slice.

``remat=True`` checkpoints every ResnetBlock and the mid-block attention
(``torch.utils.checkpoint``, the JAX package's ``nn.remat``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..core.config import VAEConfig
from ..nn.blocks import Conv2D, DownEncoderBlock, GroupNorm, MidBlock


@dataclasses.dataclass
class DiagonalGaussian:
    """Diagonal Gaussian posterior over NHWC latents (diffusers
    ``DiagonalGaussianDistribution``): logvar clamped to [-30, 20]."""

    mean: torch.Tensor    # (B, h, w, C)
    logvar: torch.Tensor  # (B, h, w, C)

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=-1)
        return cls(mean=mean, logvar=logvar.clamp(-30.0, 20.0))

    def mode(self) -> torch.Tensor:
        return self.mean

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """mean + exp(logvar / 2) * eps, eps ~ N(0, I) from ``generator``
        (on the tensors' device)."""
        eps = torch.randn(self.mean.shape, generator=generator,
                          device=self.mean.device, dtype=torch.float32)
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


class AutoencoderKL(nn.Module):
    """The encode half of the VAE (``encoder`` and ``quant_conv``)."""

    def __init__(self, config: VAEConfig, remat: bool = False):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, remat)
        self.quant_conv = (
            Conv2D(2 * config.latent_channels, 2 * config.latent_channels, 1,
                   padding=0) if config.use_quant_conv else None)

    def encode(self, x) -> DiagonalGaussian:
        """NHWC pixels in [-1, 1], in the compute dtype -> posterior (fp32)."""
        moments = self.encoder(x)
        if self.quant_conv is not None:
            moments = self.quant_conv(moments)
        return DiagonalGaussian.from_moments(moments.float())


def encode_scaled(posterior_mode: torch.Tensor,
                  config: VAEConfig) -> torch.Tensor:
    """latent * scaling_factor + shift_factor (the diffusers wrapper's
    encode transform)."""
    return posterior_mode * config.scaling_factor + config.shift_factor
