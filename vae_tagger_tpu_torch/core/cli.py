"""Argument groups of the trainer CLI (the port's copy of the builders in
``vae_tagger_tpu/core/cli.py`` that ``scripts/train_full.py`` uses), plus
``--device``.

The reference's quirks are kept: ``--use_attention`` and its two
sub-flags are store_true with default True (``--no_attention`` turns the
attention head off), and ``--mixed_precision`` takes "no", "fp16" or
"bf16", fp16 and bf16 both running bf16 (core/precision.py).  Flags whose
path the port has not taken yet are accepted by the parser and refused by
:func:`refuse_unported` at start, so none is silently ignored.
"""

from __future__ import annotations

import argparse


def add_vae_args(p: argparse.ArgumentParser, require_checkpoint: bool = False):
    p.add_argument("--vae_checkpoint", type=str,
                   required=require_checkpoint, default=None,
                   help="pretrained VAE weights (.safetensors/.bin)")
    p.add_argument("--vae_config_path", type=str, default=None,
                   help="VAE config file (diffusers-style JSON)")


def add_decoder_ckpt_arg(p: argparse.ArgumentParser, required: bool = False):
    p.add_argument("--decoder_checkpoint", type=str, required=required,
                   default=None, help="decoder weights (.bin/.pth)")


def add_attention_args(p: argparse.ArgumentParser):
    p.add_argument("--use_attention", action="store_true", default=True,
                   help="use the attention decoder (default on)")
    p.add_argument("--no_attention", action="store_true",
                   help="disable the attention decoder")
    p.add_argument("--use_spatial_attention", action="store_true",
                   default=True)
    p.add_argument("--use_self_attention", action="store_true", default=True)
    p.add_argument("--use_cross_attention", action="store_true")
    p.add_argument("--attention_heads", type=int, default=8)
    p.add_argument("--attention_dropout", type=float, default=0.1)


def add_bucketing_args(p: argparse.ArgumentParser):
    p.add_argument("--use_bucketing", action="store_true",
                   help="aspect-ratio bucketing (not ported yet: refused)")
    p.add_argument("--base_resolution", type=int, default=512)
    p.add_argument("--max_resolution", type=int, default=1024)
    p.add_argument("--bucket_step", type=int, default=64)


def add_data_args(p: argparse.ArgumentParser):
    p.add_argument("--json_path", type=str, required=True)
    p.add_argument("--tags_csv_path", type=str, required=True)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--prefetch_factor", type=int, default=2)


def add_train_args(p: argparse.ArgumentParser, default_lr: float = 1e-4):
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=default_lr)
    p.add_argument("--weight_decay", type=float, default=1e-6)
    p.add_argument("--lr_scheduler_type", type=str, default="cosine")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--save_steps", type=int, default=5,
                   help="checkpoint interval in epochs")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mixed_precision", type=str, default="fp16",
                   help="no|fp16|bf16 (fp16 and bf16 both run bf16)")
    # accepted for the reference CLI's sake; they select nothing here
    p.add_argument("--enable_xformers_memory_efficient_attention",
                   action="store_true",
                   help="(compat) the flash-attention kernels always run")
    p.add_argument("--cudnn_benchmark", action="store_true",
                   help="(compat) no effect")
    p.add_argument("--cudnn_deterministic", action="store_true",
                   help="(compat) no effect: the kernels use no atomics")
    p.add_argument("--use_safetensors", action="store_true",
                   help="(compat) safetensors is always used for the VAE")
    p.add_argument("--use_quant_conv", action="store_true")
    p.add_argument("--use_post_quant_conv", action="store_true")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="profiler capture (not ported yet: refused)")
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing of every ResnetBlock and "
                   "the attention, and of the whole triplet encode")
    p.add_argument("--sync_checkpoints", action="store_true",
                   help="(compat) the port always writes checkpoints "
                   "synchronously")
    p.add_argument("--spatial_parallel", action="store_true",
                   help="height-sharded multi-device training (not ported "
                   "yet: refused)")
    p.add_argument("--transfer_format", type=str, default="rgb",
                   choices=("rgb", "yuv420"),
                   help="image wire format; only rgb is ported")
    p.add_argument("--val_draws", type=int, default=1,
                   help="average this many paired posterior draws per "
                   "validation batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")


def add_loss_args(p: argparse.ArgumentParser):
    p.add_argument("--reconstruction_weight", type=float, default=0.01)
    p.add_argument("--kl_weight", type=float, default=1e-7)
    p.add_argument("--triplet_weight", type=float, default=1.0)
    p.add_argument("--bce_weight", type=float, default=1.0)
    p.add_argument("--triplet_margin", type=float, default=1.0)
    p.add_argument("--use_simplified_loss", action="store_true", default=True)
    p.add_argument("--no_simplified_loss", action="store_true",
                   help="the full combined loss (not ported yet: refused)")
    p.add_argument("--use_focal_loss", action="store_true")
    p.add_argument("--use_class_balanced", action="store_true")
    p.add_argument("--use_adaptive_weights", action="store_true",
                   help="learnable loss weights (not ported yet: refused)")
    p.add_argument("--focal_alpha", type=float, default=1.0)
    p.add_argument("--focal_gamma", type=float, default=2.0)
    p.add_argument("--similarity_type", type=str, default="cosine",
                   choices=["cosine", "euclidean"])


def refuse_unported(args) -> None:
    """Raise for a flag whose path the port does not run yet."""
    refused = [flag for flag, on in (
        ("--use_bucketing", getattr(args, "use_bucketing", False)),
        ("--transfer_format yuv420",
         getattr(args, "transfer_format", "rgb") != "rgb"),
        ("--no_simplified_loss", getattr(args, "no_simplified_loss", False)),
        ("--use_adaptive_weights",
         getattr(args, "use_adaptive_weights", False)),
        ("--spatial_parallel", getattr(args, "spatial_parallel", False)),
        ("--profile_steps", bool(getattr(args, "profile_steps", 0))),
    ) if on]
    if refused:
        raise SystemExit(
            f"not ported to vae_tagger_tpu_torch yet: {', '.join(refused)} "
            f"(ROADMAP.md lists what is left)")


def resolve_attention_flags(args) -> dict | None:
    """Apply --no_attention and build the attention config dict."""
    if getattr(args, "no_attention", False):
        args.use_attention = False
    if not args.use_attention:
        return None
    return {
        "use_spatial_attention": args.use_spatial_attention,
        "use_self_attention": args.use_self_attention,
        "use_cross_attention": args.use_cross_attention,
        "attention_heads": args.attention_heads,
        "attention_dropout": args.attention_dropout,
    }
