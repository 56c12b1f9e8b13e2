"""The train and eval steps of ``train_full``, ``train_vae`` and
``train_decoder`` (the port's counterparts of ``make_full_steps``,
``make_vae_steps`` and ``make_decoder_steps`` in
``vae_tagger_tpu/train/steps.py``).

``FullSteps``, one step: the anchor, positive and negative images run as
ONE stacked 3B encode -> posterior draw z (explicit generator) -> the
triplet term on z -> the anchor's scaled posterior mean, detached, into the
tagger head (train mode: dropout from the same generator, BatchNorm on
batch statistics) -> the classification term -> backward through the head
and the whole encoder (kernels A, B, C forward; C's backward is kernels D
and E) -> clip + AdamW.  With the full loss (``use_simplified=False``) the
anchor is also decoded from a posterior draw of its own and the loss adds
the reconstruction MSE and the log-damped KL, with fixed or adaptive
weights.

``VaeSteps``, one step: the stacked 3B encode -> the triplet draw -> the
triplet term; the anchor decoded from its own draw -> the reconstruction
MSE against the normalized anchor in fp32; the log-damped KL, optimized
unless ``use_simplified`` (then only reported).

``DecoderSteps``: the frozen VAE encodes under no gradient (posterior
mode, scaled, cast to the compute dtype), then the head trains on the
classification term alone; only the head's parameters are in the
optimizer.  Its ``*_from_latents`` forms take latents directly, for the
latent cache of ``train_decoder --cache_latents``.

A batch in the YUV 4:2:0 wire format (``<key>_y``, ``<key>_cbcr``) is
turned back into uint8 RGB on the device at the top of every step body
(:func:`resolve_transfer_format`), so what follows is the RGB path fed the
converted pixels.

The reconstruction's draw is independent of the triplet's: it comes from a
second generator of the same step (``step_generator(..., stream=1)``).  The
JAX package measured that one shared draw destabilizes training (its
``make_vae_steps``; ``benchmarks/vae_dynamics_probe.py``).

Data parallelism (one process per GPU, parallel/mesh.py): each process
runs these steps on its slice of the global batch, and a step equals one
process's step on the global batch, as XLA's SPMD step equals the
single-device one.  What makes it so:

- the optimizer averages the gradients over the processes once per
  update (train/state.py).  That is exact for every term that is a mean
  of per-sample values over the batch, because the local batches are
  equal: the triplet term, the focal, BCE and class-balanced terms, the
  reconstruction MSE, and ``AdaptiveLossWeights``, which is linear in
  the term means (its weights depend on its parameters, not on the
  batch);
- the terms that mix samples see the global batch: the head's
  train-mode BatchNorm all-reduces its statistics, with their gradient
  (models/taggers.py), and the log-damped KL takes ``log1p`` of the
  global mean KL (losses/combined.py), whose all-reduce's backward sums
  what every process's copy of the term sends back;
- the noise is the global batch's: every process draws the whole global
  batch's posterior and dropout noise from the step's generator and
  keeps its own rows (of each third of the anchor/positive/negative
  stack), so the generators advance as in one process;
- the metrics a step returns are averaged over the processes, so rank 0
  logs what one process would.

Spatial parallelism (``spatial=``, a one-row SpatialMesh; one process,
parallel/spatial.py): the VAE's encode (and the full loss's decode) run
their body on height slabs, one a device, and gather the moments (the
image) back to the first device, where the posterior draw, the head, the
losses and the optimizer run as they do unsharded.  The master
parameters stay there and the slabs read them through ``.to``, so their
gradients sum into the master ``.grad``; the batch is not multiplied.

While a profiler runs, a train step is the span ``steps.train_step``
holding its phases ``steps.place`` (:func:`batch_to_device`, also in eval
steps), ``steps.forward``, ``steps.backward`` and ``steps.optimizer``
(train/state.py adds ``steps.grad_allreduce`` inside it); in
``DecoderSteps`` the span is the head's step,
:meth:`DecoderSteps.train_step_from_latents` (utils/profiling.py).

The TPU's sublane padding of the stacked batch and its per-member bs1
encodes are not carried over.  The head is fed its latents in the compute
dtype, in which the trainers build it (models/taggers.py), as the JAX
package's steps do.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..losses.combined import (
    LossConfig,
    classification_term,
    combined_loss,
    log_damped_kl,
    simplified_combined_loss,
)
from ..losses.metric_learning import triplet_loss
from ..models.autoencoder_kl import DiagonalGaussian
from ..ops.image import normalize_uint8, yuv420_to_rgb_uint8
from ..parallel.mesh import mean_over_processes
from ..utils.profiling import ranged, span
from .state import TrainState

_BATCH_KEYS = ("anchor", "positive", "negative", "labels", "positive_labels")
_IMAGE_KEYS = ("pixel_values", "anchor", "positive", "negative")
# eval draws use their own generator stream, as the JAX package folds
# 10,000,000 + index into its key
_EVAL_STREAM = 10_000_000


def step_generator(device, seed: int, index: int,
                   stream: int = 0) -> torch.Generator:
    """The generator of one step: a pure function of (seed, index, stream);
    stream 0 draws the triplet posterior and the head's dropout, stream 1
    the reconstruction's posterior."""
    g = torch.Generator(device=device)
    # the CPU generator reads the low 32 bits of the seed: streams differ
    # there (a golden-ratio offset, far from any index a run reaches)
    g.manual_seed((int(seed) * 1_000_003 + int(index)
                   + int(stream) * 0x9E3779B9) & 0xFFFFFFFFFFFFFFFF)
    return g


def step_generators(device, seed: int, index: int):
    """(triplet generator, reconstruction generator) of one step."""
    return (step_generator(device, seed, index),
            step_generator(device, seed, index, stream=1))


@ranged("steps.place")
def batch_to_device(batch: dict, device, keys=_BATCH_KEYS) -> dict:
    """The numpy arrays of ``keys`` that a step reads, an image key also in
    its YUV form (``<key>_y``, ``<key>_cbcr``), on ``device`` (pinned,
    non-blocking host->device copies on the card)."""
    out = {}
    for key in keys:
        for k in (key, key + "_y", key + "_cbcr"):
            if k not in batch:
                continue
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
    return out


def resolve_transfer_format(batch: dict) -> dict:
    """Turn the YUV 4:2:0 pairs of a device batch (``<key>_y`` (B, H, W),
    ``<key>_cbcr`` (B, 2, H/2, W/2), uint8) back into uint8 RGB under the
    original keys (ops/image.py::yuv420_to_rgb_uint8); an RGB batch passes
    through untouched."""
    if not any(k.endswith("_y") for k in batch):
        return batch
    batch = dict(batch)
    for key in _IMAGE_KEYS:
        if key + "_y" in batch:
            batch[key] = yuv420_to_rgb_uint8(batch.pop(key + "_y"),
                                             batch.pop(key + "_cbcr"))
    return batch


def triplet_posterior(vae, batch: dict, compute_dtype,
                      checkpoint_encode: bool,
                      spatial=None) -> DiagonalGaussian:
    """Posterior over the stacked (3B) anchor/positive/negative batch,
    height-sharded over ``spatial`` when given.  ``checkpoint_encode``
    checkpoints the whole encode as well (on top of the blocks' remat), so
    the backward holds one encode's state at most."""
    images = torch.cat([batch["anchor"], batch["positive"],
                        batch["negative"]])

    def encode(px):
        post = vae.encode(normalize_uint8(px, compute_dtype), spatial)
        return post.mean, post.logvar

    if checkpoint_encode:
        mean, logvar = checkpoint(encode, images, use_reentrant=False)
    else:
        mean, logvar = encode(images)
    return DiagonalGaussian(mean=mean, logvar=logvar, parts=3)


def anchor_reconstruction(vae, posterior: DiagonalGaussian, batch: dict,
                          compute_dtype, generator: torch.Generator,
                          spatial=None):
    """(reconstruction of the anchor from a posterior draw of its own, the
    anchor normalized in fp32): the draw from ``generator``, independent
    of the triplet's; the decode height-sharded over ``spatial`` when
    given."""
    b = batch["anchor"].shape[0]
    z = DiagonalGaussian(mean=posterior.mean[:b],
                         logvar=posterior.logvar[:b]).sample(generator)
    return (vae.decode(z, compute_dtype, spatial),
            normalize_uint8(batch["anchor"], torch.float32))


def _detached(loss_dict: dict, total) -> dict:
    metrics = {k: v.detach() for k, v in loss_dict.items()
               if k not in ("total_loss", "weights")}
    metrics["loss"] = total.detach()
    return metrics


class _Steps:
    """The step loop shared by both trainers: ``forward_losses(state,
    batch, generator, train=, recon_generator=)`` -> (total, metrics,
    probabilities)."""

    @ranged("steps.train_step")
    def train_step(self, state: TrainState, batch: dict,
                   global_step: int) -> dict:
        """One micro-step: loss, backward, and the optimizer's step (which
        applies an update every ``accumulation_steps``)."""
        device = next(state.vae.parameters()).device
        g, g_recon = step_generators(device, self.seed, global_step)
        placed = batch_to_device(batch, device)
        with span("steps.forward"):
            total, metrics, _ = self.forward_losses(
                state, placed, g, train=True, recon_generator=g_recon)
        with span("steps.backward"):
            total.backward()
        with span("steps.optimizer"):
            state.optimizer.step()
        state.step += 1
        return mean_over_processes(metrics)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict, index: int) -> dict:
        """Losses (and the head's probabilities, where there is a head),
        head in eval mode, posterior draws from the eval stream
        ``index``."""
        device = next(state.vae.parameters()).device
        g, g_recon = step_generators(device, self.seed, _EVAL_STREAM + index)
        _, metrics, probs = self.forward_losses(
            state, batch_to_device(batch, device), g, train=False,
            recon_generator=g_recon)
        if probs is not None:
            metrics["probs"] = probs
        return mean_over_processes(metrics)


class FullSteps(_Steps):
    """train_full's steps over a :class:`TrainState` on one device; the
    full loss needs ``state.vae`` built with its decoder, and
    ``state.adaptive`` with ``cfg.use_adaptive_weights``."""

    def __init__(self, cfg: LossConfig, *, use_simplified: bool = True,
                 cb_weights=None, compute_dtype=torch.float32,
                 checkpoint_encode: bool = False, seed: int = 0,
                 spatial=None):
        self.cfg = cfg
        self.use_simplified = use_simplified
        self.cb_weights = cb_weights
        self.compute_dtype = compute_dtype
        self.checkpoint_encode = checkpoint_encode
        self.seed = seed
        self.spatial = spatial

    def forward_losses(self, state: TrainState, batch: dict,
                       generator: torch.Generator, *, train: bool,
                       recon_generator: torch.Generator = None):
        """(total loss, metrics, probabilities) of one device batch; the
        total carries the graph when grad mode is on.  ``generator`` draws
        the triplet posterior and the head's dropout, ``recon_generator``
        the reconstruction's posterior (full loss only)."""
        batch = resolve_transfer_format(batch)
        vae, decoder = state.vae, state.decoder
        b = batch["anchor"].shape[0]
        posterior = triplet_posterior(vae, batch, self.compute_dtype,
                                      self.checkpoint_encode, self.spatial)
        z = posterior.sample(generator)
        latents = vae.scale_latents(posterior.mean[:b]).detach()
        decoder.train(train)
        logits = decoder(latents.to(self.compute_dtype), generator)
        labels = batch["labels"]
        if self.use_simplified:
            total, loss_dict = simplified_combined_loss(
                self.cfg, z[:b], z[b:2 * b], z[2 * b:],
                classification_logits=logits,
                classification_targets=labels, anchor_labels=labels,
                positive_labels=batch["positive_labels"],
                cb_weights=self.cb_weights)
        else:
            recon, anchor = anchor_reconstruction(
                vae, posterior, batch, self.compute_dtype, recon_generator,
                self.spatial)
            kl = posterior.kl()
            total, loss_dict = combined_loss(
                self.cfg, recon, anchor, kl[:b], kl[b:2 * b], kl[2 * b:],
                z[:b], z[b:2 * b], z[2 * b:], logits, labels,
                anchor_labels=labels,
                positive_labels=batch["positive_labels"],
                cb_weights=self.cb_weights,
                adaptive_weights=state.adaptive)
        return (total, _detached(loss_dict, total),
                torch.sigmoid(logits.detach().float()))


class VaeSteps(_Steps):
    """train_vae's steps over a :class:`TrainState` without a head; the VAE
    is built with its decoder."""

    def __init__(self, cfg: LossConfig, *, use_simplified: bool = True,
                 compute_dtype=torch.float32, checkpoint_encode: bool = False,
                 seed: int = 0, spatial=None):
        self.cfg = cfg
        self.use_simplified = use_simplified
        self.compute_dtype = compute_dtype
        self.checkpoint_encode = checkpoint_encode
        self.seed = seed
        self.spatial = spatial

    def forward_losses(self, state: TrainState, batch: dict,
                       generator: torch.Generator, *, train: bool,
                       recon_generator: torch.Generator = None):
        """(total loss, metrics, None) of one device batch; ``generator``
        draws the triplet posterior, ``recon_generator`` the
        reconstruction's."""
        batch = resolve_transfer_format(batch)
        cfg, vae = self.cfg, state.vae
        b = batch["anchor"].shape[0]
        posterior = triplet_posterior(vae, batch, self.compute_dtype,
                                      self.checkpoint_encode, self.spatial)
        z = posterior.sample(generator)
        recon, anchor = anchor_reconstruction(vae, posterior, batch,
                                              self.compute_dtype,
                                              recon_generator, self.spatial)
        recon_loss = (recon.float() - anchor).square().mean()
        kl = posterior.kl()
        kl_loss = log_damped_kl(kl[:b], kl[b:2 * b], kl[2 * b:])
        trip = triplet_loss(z[:b], z[b:2 * b], z[2 * b:], batch["labels"],
                            batch["positive_labels"],
                            margin=cfg.triplet_margin,
                            similarity_type=cfg.similarity_type)
        # KL is reported either way; optimized only with the full loss
        if self.use_simplified:
            total = (cfg.reconstruction_weight * recon_loss
                     + cfg.triplet_weight * trip)
        else:
            total = (cfg.reconstruction_weight * recon_loss
                     + cfg.kl_weight * kl_loss + cfg.triplet_weight * trip)
        metrics = {"reconstruction_loss": recon_loss.detach(),
                   "kl_loss": kl_loss.detach(), "triplet_loss": trip.detach(),
                   "loss": total.detach()}
        return total, metrics, None


class DecoderSteps:
    """train_decoder's steps: the frozen ``vae`` (not in the train state)
    encodes, the head ``state.decoder`` trains on the classification
    term."""

    def __init__(self, vae, cfg: LossConfig, *, cb_weights=None,
                 compute_dtype=torch.float32, seed: int = 0, spatial=None):
        self.vae = vae
        self.cfg = cfg
        self.cb_weights = cb_weights
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.spatial = spatial

    @property
    def device(self) -> torch.device:
        return next(self.vae.parameters()).device

    def to_device(self, batch: dict) -> dict:
        """The pixels (RGB or YUV) and labels of a host batch, on the
        VAE's device."""
        return batch_to_device(batch, self.device,
                               ("pixel_values", "labels"))

    @torch.no_grad()
    def encode_batch(self, batch: dict) -> torch.Tensor:
        """Latents of a device batch: the posterior mode, scaled, in the
        compute dtype; no gradient reaches the VAE."""
        px = resolve_transfer_format(batch)["pixel_values"]
        posterior = self.vae.encode(normalize_uint8(px, self.compute_dtype),
                                    self.spatial)
        return self.vae.scale_latents(posterior.mode()).to(
            self.compute_dtype)

    @ranged("steps.train_step")
    def train_step_from_latents(self, state: TrainState, latents, labels,
                                global_step: int) -> dict:
        """One micro-step of the head on latents: the loss, its backward
        and the optimizer's step; dropout from the step's generator."""
        head = state.decoder
        head.train()
        g = step_generator(latents.device, self.seed, global_step)
        with span("steps.forward"):
            loss = classification_term(
                self.cfg, head(latents.to(self.compute_dtype), g), labels,
                self.cb_weights)
        with span("steps.backward"):
            loss.backward()
        with span("steps.optimizer"):
            state.optimizer.step()
        state.step += 1
        return mean_over_processes({"loss": loss.detach()})

    @torch.no_grad()
    def eval_step_from_latents(self, state: TrainState, latents,
                               labels) -> dict:
        """The loss and the probabilities, head in eval mode."""
        state.decoder.eval()
        logits = state.decoder(latents.to(self.compute_dtype))
        loss = classification_term(self.cfg, logits, labels, self.cb_weights)
        return mean_over_processes(
            {"loss": loss, "probs": torch.sigmoid(logits.float())})

    def train_step(self, state: TrainState, batch: dict,
                   global_step: int) -> dict:
        b = self.to_device(batch)
        return self.train_step_from_latents(state, self.encode_batch(b),
                                            b["labels"], global_step)

    def eval_step(self, state: TrainState, batch: dict, index: int = 0
                  ) -> dict:
        b = self.to_device(batch)
        return self.eval_step_from_latents(state, self.encode_batch(b),
                                           b["labels"])
