"""Combined training loss of the simplified path (the port's copy of
``LossConfig``, ``classification_term``, ``simplified_combined_loss`` and
``compute_class_distribution`` from ``vae_tagger_tpu/losses/combined.py``).

The full four-term ``combined_loss``, ``log_damped_kl`` and the adaptive
weights need the VAE decoder and wait for its slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .classification import bce_with_logits, class_balanced_loss, focal_loss
from .metric_learning import contrastive_loss, triplet_loss


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


def compute_class_distribution(labels_matrix) -> np.ndarray:
    """Positive-image count per tag of an (N, num_tags) label matrix."""
    return (np.asarray(labels_matrix) > 0).sum(axis=0).astype(np.float64)
