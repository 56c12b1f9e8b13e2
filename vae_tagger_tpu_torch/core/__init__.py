from .config import (
    AttentionDecoderConfig,
    VAEConfig,
    default_flux_vae_config,
    default_sd_vae_config,
    get_vae_latent_info,
    vae_config_from_dict,
    vae_config_from_file,
)
from .device import resolve_device
from .precision import BF16, FP32, Policy, resolve_mixed_precision

__all__ = [
    "AttentionDecoderConfig",
    "BF16",
    "FP32",
    "Policy",
    "VAEConfig",
    "default_flux_vae_config",
    "default_sd_vae_config",
    "get_vae_latent_info",
    "resolve_device",
    "resolve_mixed_precision",
    "vae_config_from_dict",
    "vae_config_from_file",
]
