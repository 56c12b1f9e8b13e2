"""Metric-learning losses on flattened latents, fp32 (the port's copy of
``vae_tagger_tpu/losses/metric_learning.py``):

  triplet_loss      cosine or euclidean hinge, optional label-overlap weight
  contrastive_loss  pairs with label Jaccard > 0.3 pulled together

The eps semantics are torch's: ``F.normalize`` divides by max(||x||, 1e-12)
and ``F.pairwise_distance`` adds 1e-6 inside the norm.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _flatten(x):
    return x.reshape(x.shape[0], -1).float()


def _l2_normalize(x, eps=1e-12):
    return x / x.square().sum(dim=1, keepdim=True).sqrt().clamp_min(eps)


def _pairwise_distance(a, b, eps=1e-6):
    return (a - b + eps).square().sum(dim=1).sqrt()


def _distance(a, b, similarity_type):
    if similarity_type == "cosine":
        return 1.0 - (_l2_normalize(a) * _l2_normalize(b)).sum(dim=1)
    return _pairwise_distance(a, b)


def triplet_loss(anchor, positive, negative, anchor_labels=None,
                 positive_labels=None, margin: float = 1.0,
                 similarity_type: str = "cosine"):
    """Triplet hinge on flattened latents; with labels, each triplet is
    weighted by 1 + 0.5 * overlap / anchor_tag_count."""
    a, p, n = _flatten(anchor), _flatten(positive), _flatten(negative)
    basic = (_distance(a, p, similarity_type)
             - _distance(a, n, similarity_type) + margin).clamp_min(0.0)
    if anchor_labels is not None and positive_labels is not None:
        al, pl = anchor_labels.float(), positive_labels.float()
        overlap = (al * pl).sum(dim=1)
        basic = basic * (1.0 + 0.5 * (overlap / (al.sum(dim=1) + _EPS)))
    return basic.mean()


def contrastive_loss(emb1, emb2, labels1, labels2, margin: float = 1.0,
                     similarity_type: str = "cosine"):
    """Pairwise contrastive loss: pairs with label Jaccard > 0.3 are
    similar (squared distance), others pushed past the margin; each pair
    weighted by its (dis)similarity."""
    distance = _distance(_flatten(emb1), _flatten(emb2), similarity_type)
    l1, l2 = labels1.float(), labels2.float()
    overlap = (l1 * l2).sum(dim=1)
    union = (l1 + l2 - l1 * l2).sum(dim=1)
    similarity = overlap / (union + _EPS)
    similar = similarity > 0.3
    loss = torch.where(similar, distance ** 2,
                       (margin - distance).clamp_min(0.0) ** 2)
    weight = torch.where(similar, similarity, 1.0 - similarity)
    return (loss * weight).mean()
