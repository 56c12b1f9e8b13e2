"""Frozen-VAE tagger-head training: ``python -m
vae_tagger_tpu_torch.train.train_decoder`` (the port's counterpart of
``vae_tagger_tpu/train/train_decoder.py`` and ``scripts/train_decoder.py``,
same flags, plus ``--device``).

The VAE is a constant feature extractor: it encodes each batch under no
gradient (posterior mode, scaled, in the compute dtype) and its parameters
never reach the optimizer; the head trains on the classification term
(BCE, focal or class-balanced).  Runs on the card unless ``--device cpu``
is given.  Writes ``<output_dir>/training_history.json``, the head's train
state under ``best_checkpoint/`` and ``checkpoint-{epoch}/``
(``--resume_from`` takes either), and exports ``best_pytorch_model.bin``
and ``pytorch_model.bin``, which ``python -m vae_tagger_tpu_torch.infer``
loads.  ``--decoder_checkpoint`` warm-starts the head (a key-diff report;
a failed load trains from scratch).  Then the final phase: one validation
pass shared by the threshold search and the evaluation at its global
threshold.

``--cache_latents`` keeps each sample's latents in host memory, keyed by
dataset index, after its first encode, so later epochs and the final
phase skip the encode.  The key is only sound for a deterministic
transform, so the cache runs under the center crop alone; it never keeps
the placeholder of an unreadable image (``load_ok``), and it stops growing
at ``--cache_latents_max_gb``, with one message.  Hits and misses are
counted per batch; the final phase reports its own.

``--profile_steps``, the preemption save (``interrupt_checkpoint``, then
no final phase), data parallelism under ``torchrun`` and
``--spatial_parallel`` (the frozen encode on height slabs, also for the
latent cache) as in train_full.  A run of more than one process ignores ``--cache_latents``
(the cache is keyed by the indices of one process's rows), as the JAX
package does on more than one host.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.cli import (
    add_attention_args,
    add_bucketing_args,
    add_data_args,
    add_decoder_ckpt_arg,
    add_decoder_train_args,
    add_train_args,
    add_vae_args,
    refuse_unported,
    resolve_attention_flags,
)
from ..core.config import get_vae_latent_info
from ..core.device import resolve_device
from ..core.precision import resolve_mixed_precision
from ..eval.threshold import (
    collect_predictions,
    evaluate_model,
    find_optimal_threshold,
)
from ..infer.engine import build_decoder
from ..io.checkpoints import (
    load_decoder,
    load_vae,
    restore_train_state,
    save_decoder_bin,
    save_train_state,
)
from ..losses.classification import class_balanced_weights
from ..losses.combined import LossConfig
from ..parallel.mesh import (
    broadcast_from_main,
    initialize_distributed,
    is_main_process,
    process_count,
)
from ..parallel.spatial import trainer_mesh
from .loop import EpochLoop, build_dataset_and_loaders
from .schedule import build_lr_schedule
from .state import TrainState, build_optimizer
from .steps import DecoderSteps


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.train.train_decoder",
        description="Train the tagger head on a frozen VAE.")
    add_vae_args(p, require_checkpoint=True)
    add_decoder_ckpt_arg(p)
    add_data_args(p)
    p.add_argument("--output_dir", type=str, default="decoder_output")
    add_train_args(p, default_lr=1e-3)
    add_attention_args(p)
    add_bucketing_args(p)
    add_decoder_train_args(p)
    return p


class LatentCache:
    """Latents by dataset index in host memory, up to ``cap_bytes``."""

    def __init__(self, cap_bytes: int):
        self.cap_bytes = cap_bytes
        self.latents: dict = {}
        self.bytes = 0
        self.capped = False
        self.hits = 0
        self.misses = 0

    def lookup(self, indices):
        """The cached latents of every index, stacked, or None on a miss;
        counts one hit or miss per batch."""
        cached = [self.latents.get(i) for i in indices]
        if all(c is not None for c in cached):
            self.hits += 1
            return torch.stack(cached)
        self.misses += 1
        return None

    def store(self, indices, latents: torch.Tensor, load_ok) -> None:
        """Keep the rows of a freshly encoded batch: not the placeholder of
        an unreadable image, nothing already cached, nothing past the
        cap."""
        host = latents.cpu()
        for i, lat, good in zip(indices, host, load_ok):
            if not good or i in self.latents:
                continue
            nbytes = lat.numel() * lat.element_size()
            if self.bytes + nbytes > self.cap_bytes:
                if not self.capped:
                    self.capped = True
                    print(f"latent cache reached --cache_latents_max_gb "
                          f"({self.cap_bytes / 1e9:.1f} GB); later samples "
                          f"stay on the encode path")
                return
            self.latents[i] = lat.clone()
            self.bytes += nbytes


def train_decoder(args) -> TrainState:
    device = initialize_distributed(resolve_device(args.device))
    refuse_unported(args, process_count())
    if is_main_process():
        os.makedirs(args.output_dir, exist_ok=True)
    policy = resolve_mixed_precision(args.mixed_precision)
    attention_config = resolve_attention_flags(args)
    seed = args.seed or 0

    vae = load_vae(args.vae_checkpoint, args.vae_config_path,
                   require_checkpoint=True, resolution=args.resolution,
                   use_quant_conv=args.use_quant_conv,
                   use_post_quant_conv=args.use_post_quant_conv)
    vae.to(device).eval().requires_grad_(False)
    latent_info = get_vae_latent_info(args.resolution,
                                      vae.config.latent_channels,
                                      vae.config.downsample_factor)
    print(f"VAE latent info: {latent_info}")
    spatial = trainer_mesh(args, vae.config.downsample_factor)

    dataset, train_loader, val_loader = build_dataset_and_loaders(
        args, return_triplets=False)
    class_names = dataset.tags
    head = build_decoder(len(class_names), args.use_attention,
                         attention_config,
                         latent_channels=vae.config.latent_channels,
                         seed=seed, dtype=policy.compute_dtype)
    if args.decoder_checkpoint and os.path.exists(args.decoder_checkpoint):
        print(f"loading pretrained decoder: {args.decoder_checkpoint}")
        try:
            load_decoder(head, args.decoder_checkpoint)
        except Exception as e:
            print(f"decoder load failed, training from scratch: {e}")
    head.to(device).train()
    broadcast_from_main(vae, head)

    cfg = LossConfig(use_focal_loss=args.use_focal_loss,
                     use_class_balanced=args.use_class_balanced,
                     focal_alpha=args.focal_alpha,
                     focal_gamma=args.focal_gamma)
    cb_weights = (class_balanced_weights(dataset.class_distribution())
                  if args.use_class_balanced else None)
    total_steps = args.num_epochs * len(train_loader)
    schedule = build_lr_schedule(args.lr_scheduler_type, args.learning_rate,
                                 args.lr_warmup_steps, total_steps)
    optimizer = build_optimizer(head.parameters(), schedule,
                                args.weight_decay, args.max_grad_norm,
                                args.gradient_accumulation_steps)
    state = TrainState(vae=None, decoder=head, optimizer=optimizer)
    steps = DecoderSteps(vae, cfg, cb_weights=cb_weights,
                         compute_dtype=policy.compute_dtype, seed=seed,
                         spatial=spatial)

    deterministic = dataset.crop_mode == "center"
    cache = None
    if args.cache_latents:
        if deterministic and process_count() == 1:
            cache = LatentCache(int(args.cache_latents_max_gb * 1e9))
        else:
            print("--cache_latents ignored: "
                  + ("multi-host run" if process_count() > 1
                     else "non-deterministic image transform "
                          f"(crop_mode={dataset.crop_mode!r})"))

    def batch_latents(batch):
        """(latents, labels) on the device: the latents from the cache on
        a hit (no pixels move), else encoded and offered to the cache."""
        indices = np.asarray(batch["index"]).tolist()
        latents = cache.lookup(indices) if cache is not None else None
        if latents is not None:
            labels = torch.from_numpy(np.asarray(batch["labels"]))
            return (latents.to(device, non_blocking=True),
                    labels.to(device, non_blocking=True))
        b = steps.to_device(batch)
        latents = steps.encode_batch(b)
        if cache is not None:
            cache.store(indices, latents, np.asarray(
                batch.get("load_ok", np.ones(len(indices), bool))))
        return latents, b["labels"]

    def run_train(state, batch, global_step):
        return steps.train_step_from_latents(state, *batch_latents(batch),
                                             global_step)

    def run_eval(state, batch, index=0):
        return steps.eval_step_from_latents(state, *batch_latents(batch))

    def save_head(state, name):
        save_decoder_bin(state.decoder, os.path.join(args.output_dir, name))
        print(f"decoder saved to: {args.output_dir}/{name}")

    def on_best(state, epoch):
        save_train_state(state, os.path.join(args.output_dir,
                                             "best_checkpoint"))
        save_head(state, "best_pytorch_model.bin")

    def on_periodic(state, epoch):
        save_train_state(state, os.path.join(args.output_dir,
                                             f"checkpoint-{epoch}"))
        save_head(state, "pytorch_model.bin")

    if args.resume_from:
        restore_train_state(state, args.resume_from)
        print(f"resumed from {args.resume_from} at step {state.step}")
        # extend the schedule's horizon past the restored count, or the
        # decaying schedules would sit at their ~0 tail for the whole run
        schedule = build_lr_schedule(args.lr_scheduler_type,
                                     args.learning_rate,
                                     args.lr_warmup_steps,
                                     state.step + total_steps)
        state.optimizer.schedule = schedule
    loop = EpochLoop(args, train_loader, val_loader, run_train, run_eval,
                     on_best, on_periodic)
    loop.run(state, lr_schedule=schedule)
    loop.save_history(args.output_dir)
    if loop.interrupted:  # preempted: the state is saved, exit fast
        print("training interrupted; skipping final evaluation")
        return state
    print("training complete; final evaluation...")
    if cache is not None:
        print(f"training latent cache: {cache.hits} cached batches, "
              f"{cache.misses} encoded batches, {len(cache.latents)} "
              f"samples, {cache.bytes / 1e6:.1f} MB")
        cache.hits = cache.misses = 0

    def predict_fn(batch):
        return run_eval(state, batch)["probs"]

    # one validation pass, shared by the threshold search and the
    # evaluation; with a warm cache it runs no encode
    collected = collect_predictions(predict_fn, val_loader)
    thresholds = find_optimal_threshold(predict_fn, val_loader, class_names,
                                        output_dir=args.output_dir,
                                        collected=collected)
    evaluate_model(predict_fn, val_loader, class_names,
                   threshold=thresholds["global_threshold"],
                   output_dir=args.output_dir, collected=collected)
    if cache is not None:
        print(f"final eval latent cache: {cache.hits} cached batches, "
              f"{cache.misses} encoded batches")
    print("training and evaluation complete")
    return state


def main(argv=None) -> TrainState:
    return train_decoder(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
