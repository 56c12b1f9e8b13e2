"""Standalone checkpoint evaluation (the port's copy of
``vae_tagger_tpu/eval/standalone.py``).

Load the exported artifacts (diffusers-layout VAE safetensors + the head's
``pytorch_model.bin``) through :class:`TaggerEngine`, run one inference
pass over a ``data.json``/``tags.csv`` dataset, and write the trainers'
evaluation files (``optimal_thresholds.json``, ``evaluation_results.csv``
and ``evaluation_results_overall.json``).  ``use_val_split`` reproduces the
trainers' 90/10 split (split seed ``seed or 42``), so a checkpoint can be
scored on the validation subset it was selected on, and
``use_bucketing`` with the training run's bucket grid its bucketed
validation transform.  ``args.devices`` (the eval CLI's
``auto_data_parallel``) spreads every batch over one engine replica a
device.
"""

from __future__ import annotations

import numpy as np

from ..data.dataset import TaggedImageDataset
from ..data.loader import DataLoader, train_val_split
from ..infer.engine import TaggerEngine
from .threshold import (
    collect_predictions,
    evaluate_model,
    find_optimal_threshold,
)


def evaluate_checkpoint(args, engine: TaggerEngine | None = None) -> dict:
    """Score a trained VAE + head on a labeled dataset; returns the
    metrics, with the threshold they were taken at."""
    if engine is None:
        engine = TaggerEngine.load(
            vae_checkpoint=args.vae_checkpoint,
            decoder_checkpoint=args.decoder_checkpoint,
            tags_csv_path=args.tags_csv_path,
            vae_config_path=args.vae_config_path,
            use_attention=args.use_attention,
            attention_config=getattr(args, "attention_config", None),
            mixed_precision=getattr(args, "mixed_precision", None),
            device=getattr(args, "device", None))
    if getattr(args, "devices", None):
        engine = engine.with_devices(args.devices)

    seed = getattr(args, "seed", 42)
    dataset = TaggedImageDataset(
        json_path=args.json_path, tags_csv_path=args.tags_csv_path,
        resolution=args.resolution, return_triplets=False, seed=seed,
        use_bucketing=getattr(args, "use_bucketing", False),
        base_resolution=getattr(args, "base_resolution", 512),
        max_resolution=getattr(args, "max_resolution", 1024),
        bucket_step=getattr(args, "bucket_step", 64))
    indices = None
    if getattr(args, "use_val_split", False):
        # the trainers split with `seed or 42` (train/loop.py), seed 0
        # falling through to 42 as well
        split_seed = seed or 42
        _, indices = train_val_split(len(dataset), 0.1, seed=split_seed)
        print(f"evaluating the training val split: {len(indices)} of "
              f"{len(dataset)} samples (split seed {split_seed})")
    loader = DataLoader(dataset, args.batch_size, shuffle=False,
                        num_workers=args.num_workers,
                        prefetch_factor=args.prefetch_factor, seed=seed,
                        indices=indices)

    def predict_fn(batch):
        # the device tensor: the collection pass copies it one batch later
        probs, _ = engine.classify_async(np.asarray(batch["pixel_values"]))
        return probs

    collected = collect_predictions(predict_fn, loader)
    threshold = getattr(args, "threshold", None)
    if threshold is None:
        results = find_optimal_threshold(
            predict_fn, loader, engine.tag_names,
            output_dir=args.output_dir, collected=collected)
        threshold = results["global_threshold"]
    metrics = evaluate_model(predict_fn, loader, engine.tag_names,
                             threshold=threshold,
                             output_dir=args.output_dir,
                             collected=collected)
    metrics["threshold"] = float(threshold)
    return metrics
