"""The diffusers ``AutoencoderKL`` family: the FLUX.1 VAE and the SD VAEs
(SD 1.x/2.x, SDXL, SD3.5), configured as their ``vae/config.json`` is.

The encoder: conv_in, one down stage per ``block_out_channels`` entry of
``layers_per_block`` ResnetBlocks (GroupNorm of ``norm_num_groups`` +
SiLU + conv3x3, twice, a 1x1 shortcut where the width changes), a
stride-2 3x3 downsample on one extra row and column of zeros after every
stage but the last, the mid block (resnet, single-head attention,
resnet), GroupNorm + SiLU + conv3x3 to 2 x ``latent_channels`` moments,
and the 1x1 quant conv where ``use_quant_conv``.  The head is fed
``mean * scaling_factor + shift_factor``: the tagger's own transform (its
inference feeds the head ``mode * scale + shift``); diffusers' FLUX
pipeline applies ``(z - shift) * scale`` before its transformer instead,
which this system never runs.

The contract this module keeps is in ``bench_port/spec.py``.
"""

from __future__ import annotations

from bench_port.arith import conv_ops
from bench_port.reference.vae import AutoencoderKLOracle

PROGRAM = ("vae_tagger_tpu_torch.core.config.vae_config_from_dict",
           "vae_tagger_tpu_torch.models.autoencoder_kl.AutoencoderKL")
TRAIN_REFERENCE = True


def reference_vae(config: dict, with_decoder: bool = True):
    v = config["vae"]
    model = AutoencoderKLOracle(
        in_channels=v["in_channels"], out_channels=v["out_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"],
        latent_channels=v["latent_channels"],
        norm_num_groups=v["norm_num_groups"],
        add_attention=v["mid_block_add_attention"],
        use_quant_conv=v["use_quant_conv"],
        use_post_quant_conv=v["use_post_quant_conv"])
    if not with_decoder:
        model.decoder = None
        model.post_quant_conv = None
    return model


def head_latents(config: dict, mean):
    v = config["vae"]
    return mean * v["scaling_factor"] + v["shift_factor"]


def latent_channels(config: dict) -> int:
    return config["vae"]["latent_channels"]


def _down(n):
    """A side after the stride-2 3x3 conv on one extra row (column) of
    zeros: (n + 1 - 3) // 2 + 1."""
    return (n - 2) // 2 + 1


def latent_side(config: dict, n: int) -> int:
    for _ in config["vae"]["block_out_channels"][1:]:
        n = _down(n)
    return n


def encoder_layers(config: dict, height: int, width: int):
    """Every conv, linear and attention product of the encoder (diffusers
    ``Encoder``) at ``height`` x ``width``; the quant conv is not counted."""
    vae = config["vae"]
    boc = vae["block_out_channels"]
    layers = [(conv_ops(height * width, boc[0], vae["in_channels"], 3),
               False)]
    h, w, ch = height, width, boc[0]
    for i, out in enumerate(boc):
        for j in range(vae["layers_per_block"]):
            c_in = ch if j == 0 else out
            layers.append((conv_ops(h * w, out, c_in, 3), True))
            layers.append((conv_ops(h * w, out, out, 3), True))
            if c_in != out:
                layers.append((conv_ops(h * w, out, c_in, 1), True))
        ch = out
        if i < len(boc) - 1:
            h, w = _down(h), _down(w)
            layers.append((conv_ops(h * w, ch, ch, 3), True))
    for _ in range(2):
        layers += [(conv_ops(h * w, ch, ch, 3), True)] * 2
    if vae.get("mid_block_add_attention", True):
        s = h * w
        layers += [(2 * s * ch * ch, True)] * 4        # q, k, v, out
        layers.append((4 * s * s * ch, True))          # q k^T and p v
        # the second resnet follows the attention
    layers.append((conv_ops(h * w, 2 * vae["latent_channels"], ch, 3),
                   True))
    return layers
