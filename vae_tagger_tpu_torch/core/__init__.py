from .config import (
    AttentionDecoderConfig,
    VAEConfig,
    WanVAEConfig,
    default_flux_vae_config,
    default_sd_vae_config,
    default_wan_vae_config,
    get_vae_latent_info,
    vae_config_from_dict,
    vae_config_from_file,
    wan_vae_config_from_dict,
)
from .device import resolve_device
from .precision import BF16, FP32, Policy, resolve_mixed_precision

__all__ = [
    "AttentionDecoderConfig",
    "BF16",
    "FP32",
    "Policy",
    "VAEConfig",
    "WanVAEConfig",
    "default_flux_vae_config",
    "default_sd_vae_config",
    "default_wan_vae_config",
    "get_vae_latent_info",
    "resolve_device",
    "resolve_mixed_precision",
    "vae_config_from_dict",
    "vae_config_from_file",
    "wan_vae_config_from_dict",
]
