"""The diffusers ``AutoencoderKLWan`` family: the Wan 2.1 VAE (also the
Wan 2.2-A14B pipelines' and Qwen-Image's), configured as its
``vae/config.json`` is, encoding one frame (an image).

The encoder on one frame: a causal 3x3x3 ``conv_in``; per stage of
``base_dim * dim_mult`` (96, 192, 384, 384 as published)
``num_res_blocks`` residual blocks (RMS norm + SiLU + causal conv3,
twice, a 1x1x1 shortcut where the width changes; attention after a block
where the stage's scale is in ``attn_scales``), a stride-2 3x3
downsample on one extra row and column of zeros after every stage but the
last; the mid block (residual block, single-head attention with a 1x1
``to_qkv`` and ``proj``, residual block); RMS norm + SiLU + causal conv3
to 2 x ``z_dim`` moments; the 1x1x1 ``quant_conv``.  On one frame only
the last temporal tap of a causal conv meets data (two zero frames are
padded in front), so each is counted as the 2-D conv of that tap.  The
head is fed ``(mean - latents_mean_c) / latents_std_c``.

The contract this module keeps is in ``bench_port/spec.py``.
"""

from __future__ import annotations

import importlib.util

import torch

from bench_port import weights
from bench_port.arith import conv_ops
from bench_port.reference.wan_vae import WanVAEOracle

PROGRAM = ("vae_tagger_tpu_torch.core.config.wan_vae_config_from_dict",
           "vae_tagger_tpu_torch.models.autoencoder_kl_wan.AutoencoderKLWan")
TRAIN_REFERENCE = False


# a program beside this harness without the Wan VAE cannot run this
# family's cells: it says so at load
if importlib.util.find_spec(PROGRAM[1].rsplit(".", 1)[0]) is None:
    raise ModuleNotFoundError(f"the program beside this harness has no "
                              f"{PROGRAM[1].rsplit('.', 1)[0]}")


def reference_vae(config: dict, with_decoder: bool = True):
    """The plain reference's encoder and ``quant_conv``; the family has no
    decoder here (``with_decoder`` builds the same)."""
    v = config["vae"]
    return WanVAEOracle(
        base_dim=v["base_dim"], z_dim=v["z_dim"],
        dim_mult=tuple(v["dim_mult"]), num_res_blocks=v["num_res_blocks"],
        attn_scales=tuple(v["attn_scales"]),
        temperal_downsample=tuple(v["temperal_downsample"]),
        latents_mean=v["latents_mean"], latents_std=v["latents_std"])


def head_latents(config: dict, mean):
    """(mean - latents_mean_c) / latents_std_c over the channels (dim 1)."""
    v = config["vae"]
    m = torch.tensor(v["latents_mean"], dtype=mean.dtype, device=mean.device)
    s = torch.tensor(v["latents_std"], dtype=mean.dtype, device=mean.device)
    return (mean - m.view(1, -1, 1, 1)) / s.view(1, -1, 1, 1)


def latent_channels(config: dict) -> int:
    return config["vae"]["z_dim"]


def _down(n):
    """A side after the stride-2 3x3 conv on one extra row (column) of
    zeros: (n + 1 - 3) // 2 + 1."""
    return (n - 2) // 2 + 1


def latent_side(config: dict, n: int) -> int:
    for _ in config["vae"]["dim_mult"][1:]:
        n = _down(n)
    return n


def _attention(s, c):
    """to_qkv (C -> 3C), proj, and the two products over s tokens."""
    return [(2 * s * c * 3 * c, True), (2 * s * c * c, True),
            (4 * s * s * c, True)]


def encoder_layers(config: dict, height: int, width: int):
    """Every conv and attention product of the encoder and ``quant_conv``
    on one frame at ``height`` x ``width``, each causal conv as the 2-D
    conv of its one tap that meets data."""
    v = config["vae"]
    dims = [v["base_dim"] * m for m in [1, *v["dim_mult"]]]
    layers = [(conv_ops(height * width, dims[0], 3, 3), False)]
    h, w = height, width
    scale = 1.0
    for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(v["num_res_blocks"]):
            layers.append((conv_ops(h * w, c_out, c_in, 3), True))
            layers.append((conv_ops(h * w, c_out, c_out, 3), True))
            if c_in != c_out:
                layers.append((conv_ops(h * w, c_out, c_in, 1), True))
            if scale in v["attn_scales"]:
                layers += _attention(h * w, c_out)
            c_in = c_out
        if i < len(v["dim_mult"]) - 1:
            h, w = _down(h), _down(w)
            layers.append((conv_ops(h * w, c_out, c_out, 3), True))
            scale /= 2.0
    c = dims[-1]
    layers += [(conv_ops(h * w, c, c, 3), True)] * 4  # the mid resnets
    layers += _attention(h * w, c)
    z2 = 2 * v["z_dim"]
    layers.append((conv_ops(h * w, z2, c, 3), True))
    layers.append((conv_ops(h * w, z2, z2, 1), True))   # quant_conv
    return layers


def weight_kind(name: str, shape) -> str | None:
    """An RMS norm's ``gamma`` is a scale; the rest as ``weights``."""
    if name.endswith(".gamma"):
        return "scale"
    return weights.leaf_kind(name, shape)


def weight_fan_in(name: str, shape) -> int:
    """A 5-D causal kernel on one frame: the fan-in of its last tap, the
    one that meets data (C_in x kh x kw)."""
    if len(shape) == 5:
        return shape[1] * shape[3] * shape[4]
    return weights.fan_in(name, shape)
