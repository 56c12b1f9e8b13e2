"""The Wan 2.1 VAE's encoder in PyTorch, NHWC, on one frame.

diffusers ``AutoencoderKLWan`` (Wan-AI/Wan2.1-T2V-14B-Diffusers,
``vae/config.json``; Wan's own ``wan/modules/vae.py``), as an image
tagger runs it: an image is a video of one frame, T = 1, encoded as the
first chunk of ``AutoencoderKLWan._encode`` with an empty feature cache.

- ``conv_in``: a causal 3x3x3 conv, 3 -> ``base_dim``.
- ``down_blocks`` (one flat list, diffusers' indices): per stage of
  ``base_dim * dim_mult``, ``num_res_blocks`` :class:`WanResidualBlock`
  (RMS norm + SiLU + causal conv3, twice, a 1x1x1 shortcut where the width
  changes; an attention block after each where the stage's scale is in
  ``attn_scales``), then, after every stage but the last, a
  :class:`WanResample`: zeros on the right and bottom and a stride-2 3x3
  conv.  A ``downsample3d``'s ``time_conv`` runs only from the second
  chunk of frames on, so on one frame it never does.
- ``mid_block``: residual block, :class:`WanAttentionBlock` (one head at
  D = the last width, 384 as published), residual block.
- the head: RMS norm + SiLU, causal conv3 to 2 x ``z_dim``, then
  ``quant_conv`` (1x1x1); the posterior's mean is the first ``z_dim``
  channels.

**One frame, 2-D convs.**  A causal conv pads its input with two zero
frames in front (``F.pad(..., (1, 1, 1, 1, 2, 0))``), so on one frame the
output is ``sum_t weight[:, :, t] * x[frame t - 2]``, and only ``t = 2``
meets data: the 3x3x3 conv is exactly the 2-D conv with ``weight[:, :,
-1]`` and padding 1 (a 1x1x1 conv, its one tap).  The port holds those
taps alone, as 2-D convs (OIHW), and runs them as the FLUX encoder runs
its convs (kernel B' / B'' for the fused residual branches, cuDNN for the
rest); ``tests/test_torch_wan_vae.py`` holds the collapse against
``F.conv3d``.  :meth:`AutoencoderKLWan.load_state_dict` takes the
diffusers layout: 5-D conv kernels are cut to their last tap, ``gamma``
(C, 1, 1[, 1]) becomes (C,), and ``time_conv`` weights are dropped
(:func:`wan_state_from_diffusers`).

The latents the tagger head reads are ``(mean - latents_mean_c) /
latents_std_c`` (:meth:`AutoencoderKLWan.scale_latents`), the Wan
pipelines' normalisation of the latent space.

Only the encoder is ported (``with_decoder=True`` raises), forward only on
the card: the RMS norm's backward and the attention backward at D = 384
are not ported, so the trainers that backpropagate through the VAE
(``train_full``, ``train_vae``) refuse this family; ``train_decoder``
reads its latents.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..core.config import WanVAEConfig
from ..nn.blocks import (
    Conv2D,
    RMSNorm,
    WanAttentionBlock,
    WanResample,
    WanResidualBlock,
)
from .autoencoder_kl import DiagonalGaussian

# what the trainers that backpropagate through the VAE would need
UNPORTED_BACKWARD = ("the RMS norm's backward, and the attention backward "
                     "(kernels D', D'', E', E'') at head width 384")


def wan_state_from_diffusers(state: dict, prefix: str = "") -> dict:
    """A diffusers ``AutoencoderKLWan`` state dict (or the part of one under
    ``prefix``) in the port's layout, as a new dict: 5-D conv kernels cut to
    their last temporal tap (the one that multiplies the first frame),
    ``gamma`` flattened to (C,), ``time_conv`` entries dropped.  Entries
    already in the port's layout pass unchanged."""
    out = {}
    for k, v in state.items():
        name = k[len(prefix):] if k.startswith(prefix) else k
        if ".time_conv." in f".{name}":
            continue
        if name.endswith("gamma"):
            v = v.reshape(-1)
        elif v.dim() == 5:
            v = v[:, :, -1].contiguous()
        out[k] = v
    return out


class WanEncoder(nn.Module):
    """diffusers ``WanEncoder3d`` on one frame; NHWC pixels in [-1, 1] ->
    (B, h, w, 2 * z_dim) before ``quant_conv``."""

    def __init__(self, config: WanVAEConfig):
        super().__init__()
        dims = config.widths
        self.conv_in = Conv2D(config.in_channels, dims[0])
        blocks = []
        scale = 1.0
        stages = len(config.dim_mult)
        for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(config.num_res_blocks):
                blocks.append(WanResidualBlock(c_in, c_out))
                if scale in config.attn_scales:
                    blocks.append(WanAttentionBlock(c_out))
                c_in = c_out
            if i != stages - 1:
                blocks.append(WanResample(c_out))
                scale /= 2.0
        self.down_blocks = nn.ModuleList(blocks)
        width = dims[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [WanResidualBlock(width, width), WanResidualBlock(width, width)])
        self.mid_block.attentions = nn.ModuleList([WanAttentionBlock(width)])
        self.norm_out = RMSNorm(width, with_silu=True)
        self.conv_out = Conv2D(width, 2 * config.z_dim)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))
        return self.conv_out(self.norm_out(x))


class AutoencoderKLWan(nn.Module):
    """The Wan VAE's encoder (+ ``quant_conv``), with the interface of
    ``AutoencoderKL``'s encode half: ``encode(x) -> DiagonalGaussian`` and
    :meth:`scale_latents`."""

    def __init__(self, config: WanVAEConfig, remat: bool = False,
                 with_decoder: bool = False):
        super().__init__()
        if with_decoder:
            raise NotImplementedError(
                "the port runs the Wan VAE's encoder only: no decoder, so no "
                "reconstruction, decoding or VAE training with this family")
        if remat:
            raise NotImplementedError(
                f"remat is a training option, and the Wan VAE does not train "
                f"in the port: missing {UNPORTED_BACKWARD}")
        self.config = config
        self.decoder = None
        self.encoder = WanEncoder(config)
        z2 = 2 * config.z_dim
        self.quant_conv = Conv2D(z2, z2, 1, padding=0)
        self.register_buffer("latents_mean", torch.tensor(
            config.latents_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("latents_std", torch.tensor(
            config.latents_std, dtype=torch.float32), persistent=False)
        self._register_load_state_dict_pre_hook(self._from_diffusers,
                                                with_module=True)

    @staticmethod
    def _from_diffusers(module, state_dict, prefix, *args):
        """load_state_dict's pre-hook: the diffusers layout, converted in
        place (:func:`wan_state_from_diffusers`)."""
        mine = {k: v for k, v in state_dict.items() if k.startswith(prefix)}
        for k in mine:
            del state_dict[k]
        state_dict.update(wan_state_from_diffusers(mine, prefix))

    def encode(self, x, spatial=None) -> DiagonalGaussian:
        """NHWC pixels in [-1, 1], in the compute dtype -> posterior
        (fp32).  No height-sharded form: ``spatial`` must hold one
        device."""
        if spatial is not None and spatial.shards > 1:
            raise NotImplementedError(
                "the Wan VAE has no height-sharded form (--spatial_parallel)")
        moments = self.quant_conv(self.encoder(x))
        return DiagonalGaussian.from_moments(moments.float())

    def scale_latents(self, mean: torch.Tensor) -> torch.Tensor:
        """The latents the tagger head reads: ``(mean - latents_mean_c) /
        latents_std_c`` over the channels (NHWC), in mean's dtype."""
        m = self.latents_mean.to(mean.device, mean.dtype)
        s = self.latents_std.to(mean.device, mean.dtype)
        return (mean - m) / s

    def decode(self, z, dtype: torch.dtype = torch.float32,
               spatial=None) -> torch.Tensor:
        raise NotImplementedError("the port runs the Wan VAE's encoder only")

