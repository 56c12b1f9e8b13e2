"""Dataset and loaders, and the epoch loop of the trainer (the port's
counterpart of ``vae_tagger_tpu/train/loop.py``, one device).

- 90/10 train/val split, one dataset shared by both loaders;
- epochs with ``set_epoch`` on the dataset (triplet mining) and the
  loaders (shuffle), so a run is a pure function of its seed;
- metrics read one step late, so the host never waits on the step it just
  queued;
- paired validation: the mining epoch is pinned and the posterior draws of
  batch i, draw d use eval stream i * val_draws + d in every epoch, so the
  epoch-to-epoch comparison behind best-checkpoint selection cancels the
  draw noise; ``--val_draws K`` averages K draws;
- history JSON (``train_loss``, ``val_loss``, ``learning_rates``,
  ``train_metrics`` per loss term), best and periodic callbacks;
- resume: the step count of a restored state continues the epoch numbering
  and skips the batches of a half-done epoch.

The SIGTERM preempt handler and ``--profile_steps`` wait for a later slice.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np

from ..data.dataset import TaggedImageDataset
from ..data.loader import DataLoader, train_val_split
from ..utils.pipelining import OneInFlight

# the mining epoch pinned during validation (outside the training range)
_VAL_MINING_EPOCH = -1


def build_dataset_and_loaders(args, return_triplets: bool = True):
    """Dataset + train/val loaders from the trainer's args: aspect-ratio
    buckets with ``--use_bucketing`` (and its three size flags), the YUV
    wire format with ``--transfer_format yuv420``."""
    dataset = TaggedImageDataset(
        json_path=args.json_path, tags_csv_path=args.tags_csv_path,
        resolution=args.resolution, seed=args.seed,
        return_triplets=return_triplets,
        use_bucketing=getattr(args, "use_bucketing", False),
        base_resolution=getattr(args, "base_resolution", 512),
        max_resolution=getattr(args, "max_resolution", 1024),
        bucket_step=getattr(args, "bucket_step", 64),
        transfer_format=getattr(args, "transfer_format", "rgb") or "rgb")
    train_idx, val_idx = train_val_split(len(dataset), 0.1,
                                         seed=args.seed or 42)
    train_loader = DataLoader(dataset, args.train_batch_size, shuffle=True,
                              num_workers=args.num_workers,
                              prefetch_factor=args.prefetch_factor,
                              seed=args.seed, indices=train_idx)
    val_loader = DataLoader(dataset, args.train_batch_size, shuffle=False,
                            num_workers=max(1, args.num_workers // 2),
                            prefetch_factor=args.prefetch_factor,
                            seed=args.seed, indices=val_idx)
    print(f"train size: {len(train_idx)}, val size: {len(val_idx)}, "
          f"batch: {args.train_batch_size}")
    return dataset, train_loader, val_loader


def _real_rows(batch) -> int:
    """Rows of a batch that are not the sampler's repeats."""
    mask = batch.get("batch_mask")
    return len(batch["labels"]) if mask is None else int(mask.sum())


def _weighted_mean(pairs) -> float:
    weights = [w for _, w in pairs]
    if not pairs or not sum(weights):
        return 0.0
    return float(np.average([v for v, _ in pairs], weights=weights))


class EpochLoop:
    """Runs epochs; keeps the history; calls the checkpoint callbacks."""

    def __init__(self, args, train_loader, val_loader,
                 run_train_step: Callable, run_eval_step: Callable,
                 on_best: Callable, on_periodic: Optional[Callable] = None,
                 log_metric_keys=("loss",)):
        self.args = args
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.run_train_step = run_train_step
        self.run_eval_step = run_eval_step
        self.on_best = on_best
        self.on_periodic = on_periodic
        self.log_metric_keys = log_metric_keys
        # the schedule advances once per update, every k micro-steps
        self.grad_accum = max(1, getattr(args, "gradient_accumulation_steps",
                                         1) or 1)
        self.history = {"train_loss": [], "val_loss": [],
                        "learning_rates": [], "train_metrics": {}}
        self.best_val_loss = float("inf")

    def run(self, state, lr_schedule=None):
        args = self.args
        n_batches = max(1, len(self.train_loader))
        global_step = first_step = state.step
        # a resumed run continues the epoch numbering (fresh triplets and
        # shuffles) and replays a half-done epoch from where it stopped
        epoch_offset = first_step // n_batches
        resume_skip = first_step % n_batches
        dataset = self.train_loader.dataset
        for epoch in range(args.num_epochs):
            mining_epoch = epoch + epoch_offset
            dataset.set_epoch(mining_epoch)
            self.train_loader.set_epoch(mining_epoch)
            self.val_loader.set_epoch(mining_epoch)
            if epoch == 0 and resume_skip:
                print(f"mid-epoch resume: skipping {resume_skip} "
                      f"already-trained batches of epoch {epoch_offset}")
                self.train_loader.skip_next(resume_skip)
            epoch_t0 = time.perf_counter()
            metric_acc = {}   # key -> [(value, weight)]
            images_seen = 0

            def drain(step, step_global, metrics, n_real):
                # scalars only: the adaptive weights are a vector
                host = {k: float(v) for k, v in metrics.items()
                        if v.dim() == 0}
                for k, v in host.items():
                    metric_acc.setdefault(k, []).append((v, n_real))
                if step % args.logging_steps == 0:
                    parts = [f"Epoch: {epoch}", f"Step: {step}"]
                    parts += [f"{k}: {host[k]:.4f}"
                              for k in self.log_metric_keys if k in host]
                    if lr_schedule is not None:
                        lr = lr_schedule(step_global // self.grad_accum)
                        parts.append(f"LR: {lr:.2e}")
                    print(", ".join(parts), flush=True)

            train_pipeline = OneInFlight(drain)
            for step, batch in enumerate(self.train_loader):
                n_real = _real_rows(batch)
                metrics = self.run_train_step(state, batch, global_step)
                train_pipeline.submit(step, global_step, metrics, n_real)
                images_seen += n_real
                global_step += 1
            train_pipeline.flush()

            val_pairs = []
            val_pipeline = OneInFlight(
                lambda loss, n: val_pairs.append((float(loss), n)))
            dataset.set_epoch(_VAL_MINING_EPOCH)
            val_draws = max(1, int(getattr(args, "val_draws", 1) or 1))
            for i, batch in enumerate(self.val_loader):
                for d in range(val_draws):
                    metrics = self.run_eval_step(state, batch,
                                                 i * val_draws + d)
                    val_pipeline.submit(metrics["loss"], _real_rows(batch))
            val_pipeline.flush()
            dataset.set_epoch(mining_epoch)

            avg_train = _weighted_mean(metric_acc.get("loss", []))
            avg_val = _weighted_mean(val_pairs)
            lr = (lr_schedule(global_step // self.grad_accum)
                  if lr_schedule else 0.0)
            self.history["train_loss"].append(avg_train)
            for k, pairs in metric_acc.items():
                self.history["train_metrics"].setdefault(k, []).append(
                    _weighted_mean(pairs))
            self.history["val_loss"].append(avg_val)
            self.history["learning_rates"].append(lr)
            dt = time.perf_counter() - epoch_t0
            print(f"Epoch {epoch} completed - Train Loss: {avg_train:.4f}, "
                  f"Val Loss: {avg_val:.4f} "
                  f"({images_seen / max(dt, 1e-9):.2f} images/sec)",
                  flush=True)
            if avg_val < self.best_val_loss:
                self.best_val_loss = avg_val
                print(f"New best validation loss: {avg_val:.4f}")
                self.on_best(state, epoch)
            if (self.on_periodic is not None
                    and (epoch + 1) % args.save_steps == 0):
                self.on_periodic(state, epoch)
        return state

    def save_history(self, output_dir: str):
        with open(os.path.join(output_dir, "training_history.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.history, f, indent=2)
