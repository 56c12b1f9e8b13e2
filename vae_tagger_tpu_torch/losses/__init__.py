from .classification import (
    bce_with_logits,
    class_balanced_loss,
    class_balanced_weights,
    focal_loss,
)
from .combined import (
    AdaptiveLossWeights,
    LossConfig,
    classification_term,
    combined_loss,
    compute_class_distribution,
    log_damped_kl,
    simplified_combined_loss,
)
from .metric_learning import contrastive_loss, triplet_loss

__all__ = [
    "AdaptiveLossWeights",
    "LossConfig",
    "bce_with_logits",
    "class_balanced_loss",
    "class_balanced_weights",
    "classification_term",
    "combined_loss",
    "compute_class_distribution",
    "contrastive_loss",
    "focal_loss",
    "log_damped_kl",
    "simplified_combined_loss",
    "triplet_loss",
]
