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
bucketed transform.  ``--no_data_parallel`` is accepted and selects
nothing (one device).
"""

from __future__ import annotations

import argparse
import os

from ..core.cli import (
    add_attention_args,
    add_bucketing_args,
    add_decoder_ckpt_arg,
    add_vae_args,
    refuse_unported,
    resolve_attention_flags,
)


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
                   help="(compat) the port evaluates on one device")
    add_bucketing_args(p)
    add_attention_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    from .standalone import evaluate_checkpoint

    args = build_parser().parse_args(argv)
    refuse_unported(args)
    args.attention_config = resolve_attention_flags(args)
    os.makedirs(args.output_dir, exist_ok=True)
    metrics = evaluate_checkpoint(args)
    print(f"macro F1 {metrics['f1_macro']:.4f} @ threshold "
          f"{metrics['threshold']:.2f}; artifacts in {args.output_dir}")
    return metrics


if __name__ == "__main__":
    main()
