"""End-to-end VAE encoder + tagger training with the simplified loss:
``python -m vae_tagger_tpu_torch.train.train_full`` (the port's counterpart
of ``vae_tagger_tpu/train/train_full.py`` and ``scripts/train_full.py``,
same flags, plus ``--device``).

Runs on the card unless ``--device cpu`` is given.  Writes
``<output_dir>/training_history.json``, the train state under
``best_checkpoint/`` and ``checkpoint-{epoch}/`` (``--resume_from`` takes
either), and exports ``best_vae/``, ``vae/`` (diffusers safetensors +
``config.json``, with the loaded checkpoint's ``decoder.*`` tensors kept)
and ``best_decoder/``, ``decoder/`` (``pytorch_model.bin``), which
``python -m vae_tagger_tpu_torch.infer`` loads.

Refused at start, not yet ported: ``--use_bucketing``, ``--transfer_format
yuv420``, ``--no_simplified_loss``, ``--use_adaptive_weights``,
``--spatial_parallel``, ``--profile_steps``.  The final threshold search
and evaluation wait for the evaluation slice.
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
from ..core.device import resolve_device
from ..core.precision import resolve_mixed_precision
from ..infer.engine import build_decoder
from ..io.checkpoints import (
    load_decoder,
    load_vae,
    passthrough_vae_tensors,
    restore_train_state,
    save_decoder_bin,
    save_train_state,
    save_vae_pretrained,
)
from ..losses.classification import class_balanced_weights
from ..losses.combined import LossConfig
from .loop import EpochLoop, build_dataset_and_loaders
from .schedule import build_lr_schedule
from .state import TrainState, build_optimizer
from .steps import FullSteps


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
    refuse_unported(args)
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    policy = resolve_mixed_precision(args.mixed_precision)
    attention_config = resolve_attention_flags(args)
    seed = args.seed or 0

    vae = load_vae(args.vae_checkpoint, args.vae_config_path,
                   require_checkpoint=False, resolution=args.resolution,
                   remat=args.remat, use_quant_conv=args.use_quant_conv,
                   use_post_quant_conv=args.use_post_quant_conv)
    passthrough = (passthrough_vae_tensors(args.vae_checkpoint)
                   if args.vae_checkpoint
                   and os.path.exists(args.vae_checkpoint) else {})
    cfg_vae = vae.config
    side = args.resolution // cfg_vae.downsample_factor
    print(f"VAE latents: {cfg_vae.latent_channels} x {side} x {side}")

    dataset, train_loader, val_loader = build_dataset_and_loaders(args)
    decoder = build_decoder(len(dataset.tags), args.use_attention,
                            attention_config,
                            latent_channels=cfg_vae.latent_channels,
                            seed=seed)
    if args.decoder_checkpoint and os.path.exists(args.decoder_checkpoint):
        print(f"loading pretrained decoder: {args.decoder_checkpoint}")
        load_decoder(decoder, args.decoder_checkpoint)
    vae.to(device).train()
    decoder.to(device).train()

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
    optimizer = build_optimizer(
        [*vae.parameters(), *decoder.parameters()], schedule,
        args.weight_decay, args.max_grad_norm,
        args.gradient_accumulation_steps)
    state = TrainState(vae=vae, decoder=decoder, optimizer=optimizer)
    steps = FullSteps(cfg, cb_weights=cb_weights,
                      compute_dtype=policy.compute_dtype,
                      checkpoint_encode=args.remat, seed=seed)

    def export_models(state, vae_dir, decoder_dir):
        vae_out = os.path.join(args.output_dir, vae_dir)
        dec_out = os.path.join(args.output_dir, decoder_dir)
        os.makedirs(dec_out, exist_ok=True)
        save_vae_pretrained(state.vae, cfg_vae, vae_out, passthrough)
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
    loop = EpochLoop(args, train_loader, val_loader, steps.train_step,
                     steps.eval_step, on_best, on_periodic,
                     log_metric_keys=("loss", "triplet_loss",
                                      "classification_loss"))
    loop.run(state, lr_schedule=schedule)
    loop.save_history(args.output_dir)
    print("training complete (the final threshold search and evaluation "
          "are not ported yet)")
    return state


def main(argv=None) -> TrainState:
    args = build_parser().parse_args(argv)
    if args.no_simplified_loss:
        args.use_simplified_loss = False
    return train_full(args)


if __name__ == "__main__":
    main()
