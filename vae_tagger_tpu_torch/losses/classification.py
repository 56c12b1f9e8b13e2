"""Multi-label classification losses, fp32 whatever the model's dtype (the
port's copy of ``vae_tagger_tpu/losses/classification.py``):

  bce_with_logits      torch ``BCEWithLogitsLoss``, mean reduction
  focal_loss           alpha * (1 - exp(-bce))**gamma * bce
  class_balanced_loss  BCE scaled by Cui et al. effective-number weights
"""

from __future__ import annotations

import numpy as np
import torch


def _bce_elementwise(logits, targets):
    """Per-element BCE with logits in the stable form
    max(x, 0) - x t + log(1 + exp(-|x|))."""
    x = logits.float()
    t = targets.float()
    return x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def bce_with_logits(logits, targets):
    """Mean BCE-with-logits."""
    return _bce_elementwise(logits, targets).mean()


def focal_loss(logits, targets, alpha: float = 1.0, gamma: float = 2.0,
               reduction: str = "mean"):
    """Multi-label focal loss: alpha * (1 - exp(-bce))**gamma * bce."""
    bce = _bce_elementwise(logits, targets)
    fl = alpha * (1.0 - torch.exp(-bce)) ** gamma * bce
    if reduction == "mean":
        return fl.mean()
    if reduction == "sum":
        return fl.sum()
    return fl


def class_balanced_weights(samples_per_class, beta: float = 0.9999):
    """Effective-number weights normalized to sum to the class count (numpy,
    host-side: the class distribution is fixed for a run).  A tag with no
    positive image counts as 1, so no weight is infinite."""
    n = np.maximum(np.asarray(samples_per_class, dtype=np.float64), 1.0)
    weights = (1.0 - beta) / (1.0 - np.power(beta, n))
    return (weights / weights.sum() * len(weights)).astype(np.float32)


def class_balanced_loss(logits, targets, weights):
    """Per-element BCE scaled per class by :func:`class_balanced_weights`."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=logits.device)
    return (_bce_elementwise(logits, targets) * w[None, :]).mean()
