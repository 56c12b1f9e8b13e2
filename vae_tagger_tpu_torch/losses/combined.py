"""Combined training losses (the port's copy of
``vae_tagger_tpu/losses/combined.py``):

- ``simplified_combined_loss``: the semantic term (triplet or contrastive)
  plus the classification term (focal, BCE or class-balanced);
- ``combined_loss``: the full four-term loss, MSE reconstruction +
  log-damped KL over the three triplet posteriors + triplet +
  classification, with fixed weights or the learnable
  :class:`AdaptiveLossWeights` (softmax of zero-initialized log weights
  over a temperature, trained jointly with the models).

Each returns ``(total_loss, loss_dict)`` with scalar tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from ..parallel.mesh import global_mean
from .classification import bce_with_logits, class_balanced_loss, focal_loss
from .metric_learning import contrastive_loss, triplet_loss


class AdaptiveLossWeights(nn.Module):
    """Learnable loss weights: softmax(log_weights / temperature), the log
    weights zero-initialized and optimized with the models."""

    def __init__(self, num_losses: int = 4, temperature: float = 1.0):
        super().__init__()
        self.temperature = temperature
        self.log_weights = nn.Parameter(torch.zeros(num_losses))

    def forward(self, losses):
        weights = torch.softmax(self.log_weights / self.temperature, dim=0)
        total = sum(w * l for w, l in zip(weights, losses))
        return total, weights


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss hyperparameters (the JAX package's fields and defaults)."""

    classification_weight: float = 1.0
    triplet_weight: float = 0.5
    contrastive_weight: float = 0.0
    reconstruction_weight: float = 0.01
    kl_weight: float = 1e-2
    use_focal_loss: bool = True
    use_class_balanced: bool = False
    use_contrastive: bool = False
    use_adaptive_weights: bool = False
    focal_alpha: float = 1.0
    focal_gamma: float = 2.0
    triplet_margin: float = 1.0
    contrastive_margin: float = 1.0
    similarity_type: str = "cosine"


def classification_term(cfg: LossConfig, logits, targets, cb_weights=None):
    if cfg.use_class_balanced and cb_weights is not None:
        return class_balanced_loss(logits, targets, cb_weights)
    if cfg.use_focal_loss:
        return focal_loss(logits, targets, cfg.focal_alpha, cfg.focal_gamma)
    return bce_with_logits(logits, targets)


def simplified_combined_loss(cfg: LossConfig, z_a, z_p, z_n=None,
                             classification_logits=None,
                             classification_targets=None,
                             anchor_labels=None, positive_labels=None,
                             negative_labels=None, cb_weights=None):
    """Semantic (triplet or contrastive) + classification loss; returns
    (total, loss_dict) with scalar tensors."""
    loss_dict = {}
    total = torch.zeros((), dtype=torch.float32, device=z_a.device)
    if cfg.use_contrastive and cfg.contrastive_weight > 0:
        c = contrastive_loss(z_a, z_p, anchor_labels, positive_labels,
                             margin=cfg.contrastive_margin,
                             similarity_type=cfg.similarity_type)
        total = total + cfg.contrastive_weight * c
        loss_dict["contrastive_loss"] = c
    elif cfg.triplet_weight > 0:
        t = triplet_loss(z_a, z_p, z_n, anchor_labels, positive_labels,
                         margin=cfg.triplet_margin,
                         similarity_type=cfg.similarity_type)
        total = total + cfg.triplet_weight * t
        loss_dict["triplet_loss"] = t
    if (classification_logits is not None
            and classification_targets is not None):
        cl = classification_term(cfg, classification_logits,
                                 classification_targets, cb_weights)
        total = total + cfg.classification_weight * cl
        loss_dict["classification_loss"] = cl
    loss_dict["total_loss"] = total
    return total, loss_dict


def log_damped_kl(kl_a, kl_p, kl_n):
    """log(1 + mean KL / 10000) over the three triplet posteriors' per-sample
    KLs; under data parallelism the mean is the global batch's (the log
    does not commute with averaging over processes)."""
    kl_mean = global_mean((kl_a + kl_p + kl_n) / 3.0)
    return torch.log1p(kl_mean / 10000.0)


def combined_loss(cfg: LossConfig, reconstruction, target_images,
                  kl_a, kl_p, kl_n, z_a, z_p, z_n,
                  classification_logits, classification_targets,
                  anchor_labels=None, positive_labels=None, cb_weights=None,
                  adaptive_weights=None):
    """The full four-term loss.  ``kl_*`` are the per-sample KL vectors of
    ``DiagonalGaussian.kl()``; ``adaptive_weights`` is the
    :class:`AdaptiveLossWeights` module when ``cfg.use_adaptive_weights``."""
    recon = (reconstruction.float() - target_images.float()).square().mean()
    kl = log_damped_kl(kl_a, kl_p, kl_n)
    trip = triplet_loss(z_a, z_p, z_n, anchor_labels, positive_labels,
                        margin=cfg.triplet_margin,
                        similarity_type=cfg.similarity_type)
    cls = classification_term(cfg, classification_logits,
                              classification_targets, cb_weights)
    losses = [recon, kl, trip, cls]
    loss_dict = {"reconstruction_loss": recon, "kl_loss": kl,
                 "triplet_loss": trip, "classification_loss": cls}
    if cfg.use_adaptive_weights:
        if adaptive_weights is None:
            raise ValueError("use_adaptive_weights requires the "
                             "AdaptiveLossWeights module")
        total, weights = adaptive_weights(losses)
        loss_dict["adaptive_weights"] = weights
    else:
        total = (cfg.reconstruction_weight * recon + cfg.kl_weight * kl
                 + cfg.triplet_weight * trip
                 + cfg.classification_weight * cls)
        loss_dict["weights"] = torch.tensor(
            [cfg.reconstruction_weight, cfg.kl_weight, cfg.triplet_weight,
             cfg.classification_weight], device=recon.device)
    loss_dict["total_loss"] = total
    return total, loss_dict


def compute_class_distribution(labels_matrix) -> np.ndarray:
    """Positive-image count per tag of an (N, num_tags) label matrix."""
    return (np.asarray(labels_matrix) > 0).sum(axis=0).astype(np.float64)
