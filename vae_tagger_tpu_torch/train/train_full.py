"""End-to-end VAE + tagger training:
``python -m vae_tagger_tpu_torch.train.train_full`` (the port's counterpart
of ``vae_tagger_tpu/train/train_full.py`` and ``scripts/train_full.py``,
same flags, plus ``--device``).

The simplified loss (triplet + classification) by default; with
``--no_simplified_loss`` the full four-term loss (+ the reconstruction of
the anchor through the VAE decoder + the log-damped KL), with
``--use_adaptive_weights`` its weights learned jointly.  Runs on the card
unless ``--device cpu`` is given.  Writes ``<output_dir>/
training_history.json``, the train state under ``best_checkpoint/`` and
``checkpoint-{epoch}/`` (``--resume_from`` takes either), and exports
``best_vae/``, ``vae/`` (diffusers safetensors + ``config.json``, the whole
VAE; the decoder as loaded where the loss does not train it) and
``best_decoder/``, ``decoder/`` (``pytorch_model.bin``), which ``python -m
vae_tagger_tpu_torch.infer`` loads.  Then the final phase: one validation
pass of an anchor-only encode+classify predictor, shared by the threshold
search (``optimal_thresholds.json``) and the evaluation at the global
threshold (``evaluation_results.csv``, ``evaluation_results_overall.json``).

``--use_bucketing`` batches by aspect-ratio bucket; ``--transfer_format
yuv420`` ships planar 4:2:0 to the card; ``--profile_steps N`` writes a
chrome trace to ``<output_dir>/profile``.  On SIGTERM (or
``VAE_TAGGER_PREEMPT_AFTER_STEPS``) the run saves ``interrupt_checkpoint``
and exits without the final phase (train/loop.py).

Data parallelism: ``torchrun --nproc_per_node N -m
vae_tagger_tpu_torch.train.train_full ...`` trains on N GPUs, one process
each, at a global batch of N x ``--train_batch_size``; a step equals one
process's step on the global batch (train/steps.py), rank 0 writes every
file, and the final phase gathers every process's predictions.  A plain
``python -m`` run is one process on one GPU.  ``--spatial_parallel``
shards each image's height over every local GPU of the one process
(parallel/spatial.py): the encode of every step and of the final phase
(and the full loss's decode) run on slabs, the batch is not multiplied,
the resolutions must split over the GPUs, yuv420 is refused; a no-op on
one GPU, refused over more than one process.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..core.cli import (
    add_attention_args,
    add_bucketing_args,
    add_data_args,
    add_decoder_ckpt_arg,
    add_loss_args,
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
    refuse_vae_backward,
    restore_train_state,
    save_decoder_bin,
    save_train_state,
    save_vae_pretrained,
)
from ..losses.classification import class_balanced_weights
from ..losses.combined import AdaptiveLossWeights, LossConfig
from ..ops.image import normalize_uint8
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
from .steps import FullSteps, batch_to_device, resolve_transfer_format


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.train.train_full",
        description="Train the VAE encoder and the tagger head end to end.")
    add_data_args(p)
    p.add_argument("--output_dir", type=str, default="full_output")
    add_vae_args(p)
    add_decoder_ckpt_arg(p)
    add_train_args(p, default_lr=1e-4)
    add_attention_args(p)
    add_loss_args(p)
    add_bucketing_args(p)
    p.add_argument("--resume_from", type=str, default=None,
                   help="a train-state checkpoint directory")
    return p


def train_full(args) -> TrainState:
    refuse_vae_backward(args.vae_config_path, "train_full")
    device = initialize_distributed(resolve_device(args.device))
    refuse_unported(args, process_count())
    if is_main_process():
        os.makedirs(args.output_dir, exist_ok=True)
    policy = resolve_mixed_precision(args.mixed_precision)
    attention_config = resolve_attention_flags(args)
    seed = args.seed or 0

    vae = load_vae(args.vae_checkpoint, args.vae_config_path,
                   require_checkpoint=False, resolution=args.resolution,
                   remat=args.remat, use_quant_conv=args.use_quant_conv,
                   use_post_quant_conv=args.use_post_quant_conv,
                   with_decoder=True)
    cfg_vae = vae.config
    latent_info = get_vae_latent_info(args.resolution,
                                      cfg_vae.latent_channels,
                                      cfg_vae.downsample_factor)
    print(f"VAE latent info: {latent_info}")
    spatial = trainer_mesh(args, cfg_vae.downsample_factor)

    dataset, train_loader, val_loader = build_dataset_and_loaders(args)
    decoder = build_decoder(len(dataset.tags), args.use_attention,
                            attention_config,
                            latent_channels=cfg_vae.latent_channels,
                            seed=seed, dtype=policy.compute_dtype)
    if args.decoder_checkpoint and os.path.exists(args.decoder_checkpoint):
        print(f"loading pretrained decoder: {args.decoder_checkpoint}")
        load_decoder(decoder, args.decoder_checkpoint)
    vae.to(device).train()
    decoder.to(device).train()
    broadcast_from_main(vae, decoder)

    cfg = LossConfig(
        classification_weight=args.bce_weight,
        triplet_weight=args.triplet_weight,
        reconstruction_weight=args.reconstruction_weight,
        kl_weight=args.kl_weight,
        use_focal_loss=args.use_focal_loss,
        use_class_balanced=args.use_class_balanced,
        use_adaptive_weights=args.use_adaptive_weights,
        focal_alpha=args.focal_alpha,
        focal_gamma=args.focal_gamma,
        triplet_margin=args.triplet_margin,
        similarity_type=args.similarity_type,
    )
    cb_weights = (class_balanced_weights(dataset.class_distribution())
                  if args.use_class_balanced else None)

    total_steps = args.num_epochs * len(train_loader)
    schedule = build_lr_schedule(args.lr_scheduler_type, args.learning_rate,
                                 args.lr_warmup_steps, total_steps)
    adaptive = None
    if not args.use_simplified_loss and args.use_adaptive_weights:
        adaptive = AdaptiveLossWeights(num_losses=4).to(device)
        print("adaptive loss weights enabled (trained jointly)")
    optimizer = build_optimizer(
        [*vae.parameters(), *decoder.parameters(),
         *(adaptive.parameters() if adaptive is not None else ())],
        schedule, args.weight_decay, args.max_grad_norm,
        args.gradient_accumulation_steps)
    state = TrainState(vae=vae, decoder=decoder, optimizer=optimizer,
                       adaptive=adaptive)
    steps = FullSteps(cfg, use_simplified=args.use_simplified_loss,
                      cb_weights=cb_weights,
                      compute_dtype=policy.compute_dtype,
                      checkpoint_encode=args.remat, seed=seed,
                      spatial=spatial)

    def export_models(state, vae_dir, decoder_dir):
        vae_out = os.path.join(args.output_dir, vae_dir)
        dec_out = os.path.join(args.output_dir, decoder_dir)
        os.makedirs(dec_out, exist_ok=True)
        save_vae_pretrained(state.vae, cfg_vae, vae_out)
        save_decoder_bin(state.decoder,
                         os.path.join(dec_out, "pytorch_model.bin"))
        print(f"VAE saved to: {vae_out}")
        print(f"decoder saved to: {dec_out}")

    def on_best(state, epoch):
        save_train_state(state, os.path.join(args.output_dir,
                                             "best_checkpoint"))
        export_models(state, "best_vae", "best_decoder")

    def on_periodic(state, epoch):
        save_train_state(state, os.path.join(args.output_dir,
                                             f"checkpoint-{epoch}"))
        export_models(state, "vae", "decoder")

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
    log_keys = (("loss", "triplet_loss", "classification_loss")
                if args.use_simplified_loss else
                ("loss", "reconstruction_loss", "kl_loss", "triplet_loss",
                 "classification_loss"))
    loop = EpochLoop(args, train_loader, val_loader, steps.train_step,
                     steps.eval_step, on_best, on_periodic,
                     log_metric_keys=log_keys)
    loop.run(state, lr_schedule=schedule)
    loop.save_history(args.output_dir)
    if loop.interrupted:  # preempted: the state is saved, exit fast
        print("training interrupted; skipping final evaluation")
        return state
    print("training complete; final evaluation...")
    final_evaluation(state, val_loader, dataset.tags, policy.compute_dtype,
                     args.output_dir, spatial)
    print("training and evaluation complete")
    return state


def final_evaluation(state: TrainState, val_loader, class_names,
                     compute_dtype, output_dir: str, spatial=None):
    """One validation pass of an anchor-only encode+classify predictor (the
    head in eval mode, the encode height-sharded over ``spatial`` when
    given), shared by the threshold search and the evaluation at its
    global threshold; both write their files to ``output_dir``."""
    vae, head = state.vae, state.decoder
    device = next(vae.parameters()).device
    head.eval()

    @torch.inference_mode()
    def predict_fn(batch):
        px = resolve_transfer_format(
            batch_to_device(batch, device, ("anchor",)))["anchor"]
        posterior = vae.encode(normalize_uint8(px, compute_dtype), spatial)
        latents = vae.scale_latents(posterior.mode())
        return torch.sigmoid(head(latents.to(compute_dtype)).float())

    collected = collect_predictions(predict_fn, val_loader)
    thresholds = find_optimal_threshold(predict_fn, val_loader, class_names,
                                        output_dir=output_dir,
                                        collected=collected)
    return evaluate_model(predict_fn, val_loader, class_names,
                          threshold=thresholds["global_threshold"],
                          output_dir=output_dir, collected=collected)


def main(argv=None) -> TrainState:
    args = build_parser().parse_args(argv)
    if args.no_simplified_loss:
        args.use_simplified_loss = False
    return train_full(args)


if __name__ == "__main__":
    main()
