"""The system under test, built through its normal path from a
configuration file and the benchmark's weights.  This is the one module of
the harness (with the traffic drivers) that imports the program,
``vae_tagger_tpu_torch``."""

from __future__ import annotations

import importlib

import torch

from bench_port import spec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def apply_precision(config: dict) -> None:
    """The process's TF32 switches as the configuration states them."""
    p = config["precision"]
    torch.backends.cudnn.allow_tf32 = bool(p["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(p["matmul_allow_tf32"])


def policy(config: dict):
    from vae_tagger_tpu_torch.core.precision import Policy

    return Policy(compute_dtype=DTYPES[config["precision"]["compute"]])


def build_kernels() -> dict:
    """Build every kernel the program has (a no-op once they are in the
    checkout's build directory); {source: seconds} of those built now."""
    from vae_tagger_tpu_torch.ops import _build

    return {k: v["seconds"] for k, v in _build.build_all().items()}


def _dotted(path: str):
    """The object at the dotted import path ``package.module.name``."""
    module, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def models(config: dict, weights: dict, device, with_decoder: bool = False,
           head_dtype=torch.float32):
    """(the VAE family's VAE, AttentionClassificationDecoder) of the program
    on ``device``, holding ``weights`` (the VAE's under ``vae.``, the
    head's under ``head.``)."""
    from vae_tagger_tpu_torch.core.config import AttentionDecoderConfig
    from vae_tagger_tpu_torch.models.taggers import (
        AttentionClassificationDecoder,
    )

    from .reference.model import part

    family = spec.family(config)
    make_config, vae_class = (_dotted(p) for p in family.PROGRAM)
    h = config["head"]
    attention = AttentionDecoderConfig(
        use_spatial_attention=h["use_spatial_attention"],
        use_self_attention=h["use_self_attention"],
        use_cross_attention=h["use_cross_attention"],
        attention_heads=h["attention_heads"],
        attention_dropout=h["attention_dropout"])
    with torch.device(device):
        vae = vae_class(make_config(config["vae"]), with_decoder=with_decoder)
        head = AttentionClassificationDecoder(
            family.latent_channels(config), config["num_tags"], attention,
            head_dtype)
    vae.load_state_dict(part(weights, "vae"))
    head.load_state_dict(part(weights, "head"))
    return vae, head


def tagger_engine(config: dict, weights: dict, device):
    """The program's ``TaggerEngine`` as the infer CLI builds it: the VAE
    without its decoder, the head in the policy's compute dtype."""
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine

    pol = policy(config)
    vae, head = models(config, weights, device, False, pol.compute_dtype)
    tags = [f"tag_{i}" for i in range(config["num_tags"])]
    return TaggerEngine(vae, head, tags, pol, device)
