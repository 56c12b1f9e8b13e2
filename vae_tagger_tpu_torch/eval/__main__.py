"""Standalone evaluation CLI: ``python -m vae_tagger_tpu_torch.eval``.

Takes the flags of the JAX package's ``scripts/evaluate.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path)::

    python -m vae_tagger_tpu_torch.eval \\
        --vae_checkpoint out/best_vae/diffusion_pytorch_model.safetensors \\
        --vae_config_path out/best_vae/config.json \\
        --decoder_checkpoint out/best_decoder/pytorch_model.bin \\
        --json_path ds/data.json --tags_csv_path ds/tags.csv \\
        --output_dir eval_out

Writes the trainers' evaluation files (optimal_thresholds.json,
evaluation_results.csv and evaluation_results_overall.json).
``--use_bucketing`` with the training run's bucket grid scores the
bucketed transform.  On a host with several GPUs it runs one engine
replica on each and splits every batch over them, the batch raised to at
least 8 a GPU; ``--no_data_parallel`` keeps one GPU.
"""

from __future__ import annotations

import argparse
import os

from ..core.cli import (
    add_attention_args,
    add_bucketing_args,
    add_decoder_ckpt_arg,
    add_vae_args,
    resolve_attention_flags,
)
from ..parallel.mesh import auto_data_parallel


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.eval",
        description="Evaluate a trained VAE+decoder on a labeled dataset.")
    add_vae_args(p, require_checkpoint=True)
    add_decoder_ckpt_arg(p, required=True)
    p.add_argument("--json_path", type=str, required=True)
    p.add_argument("--tags_csv_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="evaluation_output")
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--prefetch_factor", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--threshold", type=float, default=None,
                   help="evaluate at a fixed threshold instead of searching "
                        "for the optimal one")
    p.add_argument("--use_val_split", action="store_true",
                   help="score only the trainers' 90/10 val subset (same "
                        "split seed)")
    p.add_argument("--mixed_precision", type=str, default=None)
    p.add_argument("--no_data_parallel", action="store_true",
                   help="one GPU instead of a replica on every local GPU")
    add_bucketing_args(p)
    add_attention_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    from .standalone import evaluate_checkpoint

    args = build_parser().parse_args(argv)
    args.devices, args.batch_size = auto_data_parallel(
        args.batch_size, not args.no_data_parallel, what="evaluation",
        device=args.device)
    args.attention_config = resolve_attention_flags(args)
    os.makedirs(args.output_dir, exist_ok=True)
    metrics = evaluate_checkpoint(args)
    print(f"macro F1 {metrics['f1_macro']:.4f} @ threshold "
          f"{metrics['threshold']:.2f}; artifacts in {args.output_dir}")
    return metrics


if __name__ == "__main__":
    main()
