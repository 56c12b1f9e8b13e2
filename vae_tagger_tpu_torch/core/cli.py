"""Argument groups of the port's CLIs (the port's copy of the functions in
``vae_tagger_tpu/core/cli.py`` that ``scripts/train_full.py``,
``scripts/train_vae.py``, ``scripts/train_decoder.py`` and
``scripts/evaluate.py`` use, the loss flags of ``scripts/train_vae.py``
and those of ``scripts/train_decoder.py``), plus ``--device``.

The reference's quirks are kept: ``--use_attention`` and its two
sub-flags are store_true with default True (``--no_attention`` turns the
attention head off), and ``--mixed_precision`` takes "no", "fp16" or
"bf16", fp16 and bf16 both running bf16 (core/precision.py).
``--spatial_parallel`` shards each image's height over every local device
of one process (parallel/spatial.py) and is a no-op on one device, as in
the JAX package; over more than one process :func:`refuse_unported`
refuses it at start with the JAX package's message.
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
                   help="aspect-ratio bucketing: each batch is one bucket")
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
                   help="torch.profiler capture of this many train steps "
                   "from the run's third, as a chrome trace in "
                   "<output_dir>/profile")
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing of every ResnetBlock and "
                   "the attention, and of the whole triplet encode")
    p.add_argument("--sync_checkpoints", action="store_true",
                   help="write checkpoints on the main thread from the live "
                   "state, instead of from a host snapshot on a background "
                   "writer")
    p.add_argument("--spatial_parallel", action="store_true",
                   help="shard each image's height over every local device "
                   "of one process (the batch is not multiplied); a no-op "
                   "on one device, refused over more than one process")
    p.add_argument("--transfer_format", type=str, default="rgb",
                   choices=("rgb", "yuv420"),
                   help="host->device image wire format: yuv420 ships "
                   "planar 4:2:0 (half of RGB's bytes) and turns it back "
                   "into RGB on the device")
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
                   help="the full combined loss: + reconstruction (VAE "
                   "decoder) + log-damped KL")
    p.add_argument("--use_focal_loss", action="store_true")
    p.add_argument("--use_class_balanced", action="store_true")
    p.add_argument("--use_adaptive_weights", action="store_true",
                   help="learnable loss weights, trained jointly (with "
                   "--no_simplified_loss)")
    p.add_argument("--focal_alpha", type=float, default=1.0)
    p.add_argument("--focal_gamma", type=float, default=2.0)
    p.add_argument("--similarity_type", type=str, default="cosine",
                   choices=["cosine", "euclidean"])


def add_vae_loss_args(p: argparse.ArgumentParser):
    """The loss flags of ``scripts/train_vae.py`` (its --kl_weight default
    is 1e-2, train_full's 1e-7)."""
    p.add_argument("--use_simplified_vae_loss", action="store_true",
                   default=True,
                   help="simplified VAE loss (recon + triplet; KL monitored "
                   "only)")
    p.add_argument("--reconstruction_weight", type=float, default=0.01)
    p.add_argument("--kl_weight", type=float, default=1e-2)
    p.add_argument("--triplet_weight", type=float, default=1.0)
    p.add_argument("--triplet_margin", type=float, default=1.0)
    p.add_argument("--similarity_type", type=str, default="cosine",
                   choices=["cosine", "euclidean"])


def add_decoder_train_args(p: argparse.ArgumentParser):
    """The loss and cache flags of ``scripts/train_decoder.py``."""
    p.add_argument("--use_simplified_decoder_loss", action="store_true",
                   default=True,
                   help="(compat; parsed but unused, as in the reference)")
    p.add_argument("--use_focal_loss", action="store_true")
    p.add_argument("--use_class_balanced", action="store_true")
    p.add_argument("--focal_alpha", type=float, default=1.0)
    p.add_argument("--focal_gamma", type=float, default=2.0)
    p.add_argument("--resume_from", type=str, default=None,
                   help="a train-state checkpoint directory")
    p.add_argument("--cache_latents", action="store_true",
                   help="keep each sample's frozen-VAE latents in host "
                   "memory after its first encode, so later epochs skip "
                   "the encode (needs the deterministic center crop)")
    p.add_argument("--cache_latents_max_gb", type=float, default=8.0,
                   help="host-memory cap of --cache_latents; samples past "
                   "it stay on the encode path")


def refuse_unported(args, n_processes: int = 1) -> None:
    """Raise for ``--spatial_parallel`` over ``n_processes`` > 1 processes:
    a slab of one image cannot be assembled from per-process loader
    slices, as the JAX package's ``shard_batch_spatial`` says."""
    if getattr(args, "spatial_parallel", False) and n_processes > 1:
        raise SystemExit(
            f"--spatial_parallel over {n_processes} processes: spatial "
            f"batch sharding is single-controller (one process driving all "
            f"chips); use data parallelism across processes")


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
