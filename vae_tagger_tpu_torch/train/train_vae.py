"""VAE-only triplet training: ``python -m
vae_tagger_tpu_torch.train.train_vae`` (the port's counterpart of
``vae_tagger_tpu/train/train_vae.py`` and ``scripts/train_vae.py``, same
flags, plus ``--device``).

Loss = w_recon * MSE(recon_a, anchor) + w_triplet * triplet(z_a, z_p, z_n)
[+ w_kl * log-damped KL unless ``--use_simplified_vae_loss``, the default,
which keeps the KL for monitoring only].  The triplet runs as one stacked
3B encode and only the anchor is decoded, from a posterior draw of its own
(``train/steps.py::VaeSteps``).  Runs on the card unless ``--device cpu``
is given.  Writes ``<output_dir>/training_history.json``, the train state
under ``best_checkpoint/`` and ``checkpoint-{epoch}/`` (``--resume_from``
takes either; the schedule's horizon is extended past the restored step),
and exports ``best_vae/`` and ``vae/`` (diffusers safetensors +
``config.json``).

``--use_bucketing``, ``--transfer_format yuv420``, ``--profile_steps``,
the preemption save, data parallelism under ``torchrun`` and
``--spatial_parallel`` (the encode and the anchor's decode on height
slabs) as in train_full.
"""

from __future__ import annotations

import argparse
import os

from ..core.cli import (
    add_bucketing_args,
    add_data_args,
    add_train_args,
    add_vae_args,
    add_vae_loss_args,
    refuse_unported,
)
from ..core.device import resolve_device
from ..core.precision import resolve_mixed_precision
from ..io.checkpoints import (
    load_vae,
    refuse_vae_backward,
    restore_train_state,
    save_train_state,
    save_vae_pretrained,
)
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
from .steps import VaeSteps


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.train.train_vae",
        description="Train the VAE with the triplet and reconstruction "
                    "losses.")
    add_vae_args(p)
    add_data_args(p)
    p.add_argument("--output_dir", type=str, default="vae_output")
    add_train_args(p, default_lr=1e-4)
    add_bucketing_args(p)
    add_vae_loss_args(p)
    p.add_argument("--resume_from", type=str, default=None,
                   help="a train-state checkpoint directory")
    return p


def train_vae(args) -> TrainState:
    refuse_vae_backward(args.vae_config_path, "train_vae")
    device = initialize_distributed(resolve_device(args.device))
    refuse_unported(args, process_count())
    if is_main_process():
        os.makedirs(args.output_dir, exist_ok=True)
    policy = resolve_mixed_precision(args.mixed_precision)
    seed = args.seed or 0

    vae = load_vae(args.vae_checkpoint, args.vae_config_path,
                   require_checkpoint=False, resolution=args.resolution,
                   remat=args.remat, use_quant_conv=args.use_quant_conv,
                   use_post_quant_conv=args.use_post_quant_conv,
                   with_decoder=True)
    spatial = trainer_mesh(args, vae.config.downsample_factor)
    _, train_loader, val_loader = build_dataset_and_loaders(args)
    vae.to(device).train()
    broadcast_from_main(vae)

    cfg = LossConfig(reconstruction_weight=args.reconstruction_weight,
                     kl_weight=args.kl_weight,
                     triplet_weight=args.triplet_weight,
                     triplet_margin=args.triplet_margin,
                     similarity_type=args.similarity_type)
    total_steps = args.num_epochs * len(train_loader)
    schedule = build_lr_schedule(args.lr_scheduler_type, args.learning_rate,
                                 args.lr_warmup_steps, total_steps)
    # the reference's train_vae steps the optimizer every batch; the
    # accumulation flag is honoured all the same, as in the JAX package
    optimizer = build_optimizer(vae.parameters(), schedule,
                                args.weight_decay, args.max_grad_norm,
                                args.gradient_accumulation_steps)
    state = TrainState(vae=vae, decoder=None, optimizer=optimizer)
    steps = VaeSteps(cfg, use_simplified=args.use_simplified_vae_loss,
                     compute_dtype=policy.compute_dtype,
                     checkpoint_encode=args.remat, seed=seed,
                     spatial=spatial)

    def export_vae(state, subdir):
        out = os.path.join(args.output_dir, subdir)
        save_vae_pretrained(state.vae, vae.config, out)
        print(f"VAE saved to: {out}")

    def on_best(state, epoch):
        save_train_state(state, os.path.join(args.output_dir,
                                             "best_checkpoint"))
        export_vae(state, "best_vae")

    def on_periodic(state, epoch):
        save_train_state(state, os.path.join(args.output_dir,
                                             f"checkpoint-{epoch}"))
        export_vae(state, "vae")

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
                     log_metric_keys=("loss", "reconstruction_loss",
                                      "triplet_loss", "kl_loss"))
    loop.run(state, lr_schedule=schedule)
    loop.save_history(args.output_dir)
    if loop.interrupted:  # preempted: the state is saved
        print("training interrupted; history saved")
        return state
    print("VAE training complete")
    return state


def main(argv=None) -> TrainState:
    return train_vae(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
