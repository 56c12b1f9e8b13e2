"""Checkpoint I/O for the port.

- :func:`load_vae`: diffusers-layout VAE weights (``.safetensors`` or a
  pickled ``.bin``) plus ``config.json``, loaded into the port's
  ``AutoencoderKL`` with ``load_state_dict(strict=False)`` and a key-diff
  report, as the reference loads them.  The port's modules carry the
  diffusers key names, so no key is renamed and no weight transposed.
- :func:`load_decoder`: a tagger head's ``pytorch_model.bin``, BatchNorm
  running stats included.
- :func:`passthrough_vae_tensors` and :func:`save_vae_pretrained`: the
  port's VAE has no decoder, so a trainer keeps the checkpoint's
  ``decoder.*`` and ``post_quant_conv.*`` tensors aside, unchanged, and the
  export writes them back beside the trained encoder: a whole diffusers
  VAE.  (The JAX package decays those untrained tensors by (1 - lr*wd)
  each step; the port leaves them as they are, as the reference's torch
  AdamW skips parameters without a gradient.)
- :func:`save_train_state` / :func:`restore_train_state`: the whole train
  state in one ``torch.save`` file (the JAX package's orbax checkpoint).
- :func:`torch_state_from_jax_params`: a JAX parameter tree of numpy arrays
  -> the port's ``state_dict`` (HWIO -> OIHW, (in, out) -> (out, in),
  ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_*``).  This is the
  port's own copy of the key mapping of the JAX package's
  ``io/safetensors_io.py`` and ``io/torch_bin.py``; the tests use it to give
  both packages the same weights.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import (
    VAEConfig,
    default_flux_vae_config,
    vae_config_from_file,
)

# flax module names whose trailing _<int> is a torch index (a.0, not a_0)
_INDEXED_NAMES = (
    # VAE (diffusers layout)
    "down_blocks", "up_blocks", "resnets", "attentions", "downsamplers",
    "upsamplers", "to_out",
    # tagger heads (reference nn.Sequential indices)
    "classifier", "channel_att", "spatial_att", "feature_compress",
)
_BN_LEAVES = {"mean": "running_mean", "var": "running_var"}
# keys of a full diffusers VAE checkpoint that the encode path never reads
_UNUSED_PREFIXES = ("decoder.", "post_quant_conv.")


def _torch_key(path: Tuple[str, ...], leaf: str) -> str:
    out = []
    for p in path:
        m = re.match(r"^(.*)_(\d+)$", p)
        if m and m.group(1) in _INDEXED_NAMES:
            out += [m.group(1), m.group(2)]
        else:
            out.append(p)
    return ".".join(out + [leaf])


def torch_state_from_jax_params(params: dict,
                                batch_stats: Optional[dict] = None
                                ) -> Dict[str, torch.Tensor]:
    """JAX/Flax param tree (and BatchNorm ``batch_stats``) -> torch-layout
    ``state_dict`` of fp32 tensors."""
    state: Dict[str, torch.Tensor] = {}

    def walk(node: dict, path: Tuple[str, ...], stats: bool):
        for name, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (name,), stats)
                continue
            arr = np.asarray(value, dtype=np.float32)
            leaf = name
            if stats:
                leaf = _BN_LEAVES[name]
            elif leaf == "kernel":
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                elif arr.ndim == 2:
                    arr = arr.transpose(1, 0)        # (in, out) -> (out, in)
                leaf = "weight"
            elif leaf == "scale":
                leaf = "weight"
            # np.array copies: the tensor owns writable memory
            state[_torch_key(path, leaf)] = torch.from_numpy(
                np.array(arr, order="C"))

    walk(params, (), False)
    if batch_stats:
        walk(batch_stats, (), True)
    return state


def load_state_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch-layout checkpoint (.safetensors, or pickled .bin/.pth) as a
    dict of CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path, device="cpu")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state_report(module: torch.nn.Module, state: dict,
                      label: str = "") -> Tuple[list, list]:
    """``load_state_dict(strict=False)`` with the reference's key-diff
    report; returns (missing, unexpected).  BatchNorm's
    ``num_batches_tracked`` counters are not reported."""
    dtypes = {k: v.dtype for k, v in module.state_dict().items()}
    state = {k: v.to(dtypes[k]) if k in dtypes and v.is_floating_point()
             else v for k, v in state.items()}
    result = module.load_state_dict(state, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    unexpected = list(result.unexpected_keys)
    if missing:
        print(f"{label}missing keys: {missing}")
    if unexpected:
        print(f"{label}unexpected keys: {unexpected}")
    return missing, unexpected


def warn_if_quant_convs_missing(missing) -> None:
    """Loud hint for the likeliest silent corruption of a strict=False VAE
    load: a trimmed config JSON omitted the quant flags, so diffusers'
    defaults (use_quant_conv=True) built convs a FLUX-family checkpoint does
    not have, and their random init corrupts every latent."""
    if any(k.startswith(("quant_conv.", "post_quant_conv.")) for k in missing):
        print("WARNING: the checkpoint has no quant_conv weights but the "
              "config requests them (use_quant_conv / use_post_quant_conv "
              "default TRUE when a config JSON omits them, like diffusers). "
              "If this is a FLUX-family VAE, set both to false in the "
              "config -- randomly-initialized quant convs corrupt latents.")


def load_vae(vae_checkpoint: Optional[str],
             vae_config_path: Optional[str] = None, *,
             require_checkpoint: bool = True,
             resolution: Optional[int] = None, remat: bool = False,
             use_quant_conv: bool = False,
             use_post_quant_conv: bool = False):
    """The port's ``AutoencoderKL`` (CPU, fp32): the config JSON if given,
    else the FLUX config (``sample_size`` = ``resolution`` when given);
    ``use_quant_conv``/``use_post_quant_conv`` force the SD-style quant
    convs on.  Weights come from a diffusers-layout checkpoint; keys it
    lacks keep a seeded fresh initialization (strict=False).  Without a
    checkpoint the model stays freshly initialized, unless
    ``require_checkpoint``."""
    from ..models.autoencoder_kl import AutoencoderKL
    from ..nn.blocks import seeded_init_

    have = bool(vae_checkpoint and os.path.exists(vae_checkpoint))
    if require_checkpoint and not have:
        raise RuntimeError(f"VAE checkpoint not found: {vae_checkpoint}")
    if vae_config_path and os.path.exists(vae_config_path):
        print(f"creating VAE from config file: {vae_config_path}")
        config = vae_config_from_file(vae_config_path)
    else:
        config = default_flux_vae_config()
        if resolution is not None:
            config = dataclasses.replace(config, sample_size=resolution)
    if use_quant_conv or use_post_quant_conv:
        config = dataclasses.replace(config, use_quant_conv=use_quant_conv,
                                     use_post_quant_conv=use_post_quant_conv)
    model = seeded_init_(AutoencoderKL(config, remat=remat))
    if not have:
        print("no VAE checkpoint: training from a fresh initialization")
        return model
    print(f"loading pretrained VAE weights: {vae_checkpoint}")
    state = {k: v for k, v in load_state_file(vae_checkpoint).items()
             if not k.startswith(_UNUSED_PREFIXES)}
    missing, _ = load_state_report(model, state, label="VAE ")
    warn_if_quant_convs_missing(missing)
    if missing:
        print("missing VAE keys keep their fresh initialization "
              "(strict=False load)")
    return model


def load_decoder(decoder: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a tagger head's ``pytorch_model.bin`` (params and BatchNorm
    running stats) into ``decoder`` with the key-diff report."""
    if not os.path.exists(path):
        raise RuntimeError(f"decoder checkpoint not found: {path}")
    load_state_report(decoder, load_state_file(path), label="decoder ")
    return decoder


def passthrough_vae_tensors(vae_checkpoint: str) -> Dict[str, torch.Tensor]:
    """The tensors of a diffusers VAE checkpoint that the port's encode-only
    VAE does not hold (``decoder.*``, ``post_quant_conv.*``), unchanged."""
    return {k: v for k, v in load_state_file(vae_checkpoint).items()
            if k.startswith(_UNUSED_PREFIXES)}


def save_vae_pretrained(model: torch.nn.Module, config: VAEConfig,
                        output_dir: str,
                        passthrough: Optional[Dict[str, torch.Tensor]] = None
                        ) -> None:
    """Diffusers ``save_pretrained``-style export of the port's VAE:
    ``config.json`` + ``diffusion_pytorch_model.safetensors``, with the
    ``passthrough`` tensors (:func:`passthrough_vae_tensors`) written back
    unchanged."""
    from safetensors.torch import save_file

    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.json"), "w",
              encoding="utf-8") as f:
        json.dump(config.to_json_dict(), f, indent=2)
    state = {k: v.contiguous() for k, v in (passthrough or {}).items()}
    state.update({k: v.detach().float().cpu().contiguous()
                  for k, v in model.state_dict().items()})
    save_file(state, os.path.join(output_dir,
                                  "diffusion_pytorch_model.safetensors"))


def save_decoder_bin(decoder: torch.nn.Module, path: str) -> None:
    """Save a tagger head as a reference-compatible ``pytorch_model.bin``."""
    torch.save({k: v.detach().cpu() for k, v in decoder.state_dict().items()},
               path)


_TRAIN_STATE_FILE = "train_state.pt"


def save_train_state(state, path: str) -> None:
    """Write a ``train.state.TrainState`` (step, both models with the
    head's BatchNorm buffers, AdamW moments, schedule position) to
    ``<path>/train_state.pt``, atomically."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, _TRAIN_STATE_FILE)
    tmp = final + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, final)


def restore_train_state(state, path: str):
    """Load ``<path>/train_state.pt`` (or ``path`` itself, a file) into
    ``state`` in place; returns ``state``."""
    file = (os.path.join(path, _TRAIN_STATE_FILE) if os.path.isdir(path)
            else path)
    if not os.path.exists(file):
        raise RuntimeError(f"train state not found: {file}")
    device = next(state.vae.parameters()).device
    state.load_state_dict(torch.load(file, map_location=device,
                                     weights_only=True))
    return state
