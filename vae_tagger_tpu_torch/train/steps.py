"""The train and eval steps of ``train_full`` with the simplified loss (the
port's counterpart of ``make_full_steps`` in
``vae_tagger_tpu/train/steps.py``).

One step: the anchor, positive and negative images run as ONE stacked 3B
encode -> posterior draw z (explicit generator) -> the triplet term on z ->
the anchor's scaled posterior mean, detached, into the tagger head (train
mode: dropout from the same generator, BatchNorm on batch statistics) ->
the classification term -> backward through the head and the whole encoder
(kernels A, B, C forward; C's backward is kernels D and E) -> clip + AdamW.

The TPU's sublane padding of the stacked batch and its per-member bs1
encodes are not carried over.  The head runs in fp32 whatever the VAE's
compute dtype, as the port's inference engine runs it.  The full combined
loss (with the VAE decoder) waits for its slice.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..losses.combined import LossConfig, simplified_combined_loss
from ..models.autoencoder_kl import DiagonalGaussian, encode_scaled
from ..ops.image import normalize_uint8
from .state import TrainState

_BATCH_KEYS = ("anchor", "positive", "negative", "labels", "positive_labels")
# eval draws use their own generator stream, as the JAX package folds
# 10,000,000 + index into its key
_EVAL_STREAM = 10_000_000


def step_generator(device, seed: int, index: int) -> torch.Generator:
    """The generator of one step: a pure function of (seed, index)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(index)) & 0xFFFFFFFFFFFFFFFF)
    return g


def batch_to_device(batch: dict, device) -> dict:
    """The numpy arrays a step reads, on ``device`` (pinned, non-blocking
    host->device copies on the card)."""
    out = {}
    for key in _BATCH_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[key]))
        if device.type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


def triplet_posterior(vae, batch: dict, compute_dtype,
                      checkpoint_encode: bool) -> DiagonalGaussian:
    """Posterior over the stacked (3B) anchor/positive/negative batch.
    ``checkpoint_encode`` checkpoints the whole encode as well (on top of
    the blocks' remat), so the backward holds one encode's state at most."""
    images = torch.cat([batch["anchor"], batch["positive"],
                        batch["negative"]])

    def encode(px):
        post = vae.encode(normalize_uint8(px, compute_dtype))
        return post.mean, post.logvar

    if checkpoint_encode:
        mean, logvar = checkpoint(encode, images, use_reentrant=False)
    else:
        mean, logvar = encode(images)
    return DiagonalGaussian(mean=mean, logvar=logvar)


class FullSteps:
    """train_full's steps over a :class:`TrainState` on one device."""

    def __init__(self, cfg: LossConfig, *, cb_weights=None,
                 compute_dtype=torch.float32, checkpoint_encode: bool = False,
                 seed: int = 0):
        self.cfg = cfg
        self.cb_weights = cb_weights
        self.compute_dtype = compute_dtype
        self.checkpoint_encode = checkpoint_encode
        self.seed = seed

    def forward_losses(self, state: TrainState, batch: dict,
                       generator: torch.Generator, *, train: bool):
        """(total loss, metrics, probabilities) of one device batch; the
        total carries the graph when grad mode is on."""
        vae, decoder = state.vae, state.decoder
        b = batch["anchor"].shape[0]
        posterior = triplet_posterior(vae, batch, self.compute_dtype,
                                      self.checkpoint_encode)
        z = posterior.sample(generator)
        latents = encode_scaled(posterior.mean[:b], vae.config).detach()
        decoder.train(train)
        logits = decoder(latents.float(), generator)
        labels = batch["labels"]
        total, loss_dict = simplified_combined_loss(
            self.cfg, z[:b], z[b:2 * b], z[2 * b:],
            classification_logits=logits, classification_targets=labels,
            anchor_labels=labels, positive_labels=batch["positive_labels"],
            cb_weights=self.cb_weights)
        metrics = {k: v.detach() for k, v in loss_dict.items()
                   if k != "total_loss"}
        metrics["loss"] = total.detach()
        return total, metrics, torch.sigmoid(logits.detach().float())

    def train_step(self, state: TrainState, batch: dict,
                   global_step: int) -> dict:
        """One micro-step: loss, backward, and the optimizer's step (which
        applies an update every ``accumulation_steps``)."""
        device = next(state.vae.parameters()).device
        g = step_generator(device, self.seed, global_step)
        total, metrics, _ = self.forward_losses(
            state, batch_to_device(batch, device), g, train=True)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict, index: int) -> dict:
        """Losses and probabilities, head in eval mode, posterior draw from
        the eval stream ``index``."""
        device = next(state.vae.parameters()).device
        g = step_generator(device, self.seed, _EVAL_STREAM + index)
        _, metrics, probs = self.forward_losses(
            state, batch_to_device(batch, device), g, train=False)
        metrics["probs"] = probs
        return metrics
