from .checkpoints import (
    load_decoder,
    load_state_file,
    load_vae,
    passthrough_vae_tensors,
    restore_train_state,
    save_decoder_bin,
    save_train_state,
    save_vae_pretrained,
    torch_state_from_jax_params,
)

__all__ = [
    "load_decoder",
    "load_state_file",
    "load_vae",
    "passthrough_vae_tensors",
    "restore_train_state",
    "save_decoder_bin",
    "save_train_state",
    "save_vae_pretrained",
    "torch_state_from_jax_params",
]
