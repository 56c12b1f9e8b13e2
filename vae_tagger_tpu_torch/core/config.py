"""Configuration dataclasses (the port's copy of
``vae_tagger_tpu/core/config.py``).

Field names and defaults mirror the diffusers ``AutoencoderKL`` config of
the FLUX.1 VAE, so existing ``config.json`` files load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """FLUX AutoencoderKL architecture config."""

    in_channels: int = 3
    out_channels: int = 3
    down_block_types: Sequence[str] = ("DownEncoderBlock2D",) * 4
    up_block_types: Sequence[str] = ("UpDecoderBlock2D",) * 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    act_fn: str = "silu"
    latent_channels: int = 16
    norm_num_groups: int = 32
    sample_size: int = 1024
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    use_quant_conv: bool = False
    use_post_quant_conv: bool = False
    force_upcast: bool = True
    mid_block_add_attention: bool = True

    @property
    def num_down_blocks(self) -> int:
        return len(self.down_block_types)

    @property
    def downsample_factor(self) -> int:
        # one stride-2 downsample between consecutive encoder stages
        return 2 ** (self.num_down_blocks - 1)

    def to_json_dict(self) -> dict:
        """Diffusers-layout config dict (save_pretrained-style export)."""
        return {
            "_class_name": "AutoencoderKL",
            "_diffusers_version": "0.30.0.dev0",
            "act_fn": self.act_fn,
            "block_out_channels": list(self.block_out_channels),
            "down_block_types": list(self.down_block_types),
            "force_upcast": self.force_upcast,
            "in_channels": self.in_channels,
            "latent_channels": self.latent_channels,
            "latents_mean": None,
            "latents_std": None,
            "layers_per_block": self.layers_per_block,
            "mid_block_add_attention": self.mid_block_add_attention,
            "norm_num_groups": self.norm_num_groups,
            "out_channels": self.out_channels,
            "sample_size": self.sample_size,
            "scaling_factor": self.scaling_factor,
            "shift_factor": self.shift_factor,
            "up_block_types": list(self.up_block_types),
            "use_post_quant_conv": self.use_post_quant_conv,
            "use_quant_conv": self.use_quant_conv,
        }


def default_flux_vae_config(**overrides) -> VAEConfig:
    """The FLUX.1-dev VAE config, with optional field overrides."""
    return dataclasses.replace(VAEConfig(), **overrides)


def default_sd_vae_config(**overrides) -> VAEConfig:
    """The SD 1.x/2.x VAE family (e.g. sd-vae-ft-mse): 4-channel latents,
    1x1 quant convs around the latent space, scaling 0.18215, no shift."""
    base = dict(latent_channels=4, sample_size=256, scaling_factor=0.18215,
                shift_factor=0.0, use_quant_conv=True,
                use_post_quant_conv=True)
    base.update(overrides)
    return dataclasses.replace(VAEConfig(), **base)


_VAE_FIELDS = {f.name for f in dataclasses.fields(VAEConfig)}

# diffusers AutoencoderKL constructor defaults for keys a config JSON may
# omit (SD-era configs predate the quant-conv flags and the shift factor);
# the FLUX config sets all four explicitly
_DIFFUSERS_JSON_DEFAULTS = {
    "use_quant_conv": True,
    "use_post_quant_conv": True,
    "scaling_factor": 0.18215,
    "shift_factor": 0.0,  # diffusers' None == no shift
}


def vae_config_from_dict(d: dict) -> VAEConfig:
    """Build a VAEConfig from a diffusers-style JSON dict, ignoring extra
    keys; keys the JSON omits (or sets null) get diffusers' constructor
    defaults."""
    kwargs = {}
    for k, v in d.items():
        if k in _VAE_FIELDS:
            if isinstance(v, list):
                v = tuple(v)
            if v is None and k in _DIFFUSERS_JSON_DEFAULTS:
                continue  # treat null like an absent key
            kwargs[k] = v
    for k, v in _DIFFUSERS_JSON_DEFAULTS.items():
        kwargs.setdefault(k, v)
    return VAEConfig(**kwargs)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    """The Wan 2.1 VAE (diffusers ``AutoencoderKLWan``), as its
    ``vae/config.json`` configures it; defaults are the published
    Wan-AI/Wan2.1-T2V-14B-Diffusers values.  The port runs its encoder on
    one frame (an image): ``temperal_downsample`` and ``dropout`` do not
    act there and are kept as the file gives them."""

    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Sequence[float] = ()
    temperal_downsample: Sequence[bool] = (False, True, True)
    dropout: float = 0.0
    latents_mean: Sequence[float] = (
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
    latents_std: Sequence[float] = (
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.916)
    in_channels: int = 3

    @property
    def latent_channels(self) -> int:
        return self.z_dim

    @property
    def widths(self) -> tuple:
        """Channels of the stem and of each stage: base_dim * [1] +
        dim_mult."""
        return tuple(self.base_dim * m for m in (1, *self.dim_mult))

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    def to_json_dict(self) -> dict:
        """Diffusers-layout config dict."""
        out = {"_class_name": "AutoencoderKLWan"}
        for f in dataclasses.fields(self):
            if f.name == "in_channels":
                continue
            v = getattr(self, f.name)
            out[f.name] = list(v) if isinstance(v, tuple) else v
        return out


def default_wan_vae_config(**overrides) -> WanVAEConfig:
    """The Wan 2.1 VAE config, with optional field overrides."""
    return dataclasses.replace(WanVAEConfig(), **overrides)


_WAN_FIELDS = {f.name for f in dataclasses.fields(WanVAEConfig)}


def wan_vae_config_from_dict(d: dict) -> WanVAEConfig:
    """Build a WanVAEConfig from a diffusers ``AutoencoderKLWan`` JSON dict,
    ignoring extra keys; keys the JSON omits get the published values."""
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in d.items() if k in _WAN_FIELDS and v is not None}
    return WanVAEConfig(**kwargs)


# a config JSON's ``_class_name`` -> the function that reads it; a file
# without one is an AutoencoderKL, as the JAX package reads every file
VAE_CONFIG_READERS = {
    "AutoencoderKL": vae_config_from_dict,
    "AutoencoderKLWan": wan_vae_config_from_dict,
}


def any_vae_config_from_dict(d: dict):
    """The config of the VAE family that the dict's ``_class_name`` names
    (:data:`VAE_CONFIG_READERS`); raises for a family the port lacks."""
    name = d.get("_class_name") or "AutoencoderKL"
    if name not in VAE_CONFIG_READERS:
        raise ValueError(f"the port runs no VAE of class {name!r}; it runs "
                         f"{sorted(VAE_CONFIG_READERS)}")
    return VAE_CONFIG_READERS[name](d)


def vae_config_from_file(path: str):
    """The config of a diffusers ``config.json``: a :class:`VAEConfig`, or
    a :class:`WanVAEConfig` where ``_class_name`` is
    ``AutoencoderKLWan``."""
    with open(path, "r", encoding="utf-8") as f:
        return any_vae_config_from_dict(json.load(f))


def get_vae_latent_info(resolution: int, latent_channels: int = 16,
                        downsample_factor: int = 8) -> dict:
    """Latent geometry of a square input of side ``resolution``; pass
    ``config.downsample_factor`` for other block counts."""
    side = resolution // downsample_factor
    return {"latent_channels": latent_channels, "latent_height": side,
            "latent_width": side,
            "total_dim": latent_channels * side * side}


@dataclasses.dataclass(frozen=True)
class AttentionDecoderConfig:
    """Config of the attention tagger head."""

    use_spatial_attention: bool = True
    use_self_attention: bool = True
    use_cross_attention: bool = False
    attention_heads: int = 8
    attention_dropout: float = 0.1
