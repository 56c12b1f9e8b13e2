from .classification import (
    bce_with_logits,
    class_balanced_loss,
    class_balanced_weights,
    focal_loss,
)
from .combined import (
    LossConfig,
    classification_term,
    compute_class_distribution,
    simplified_combined_loss,
)
from .metric_learning import contrastive_loss, triplet_loss

__all__ = [
    "LossConfig",
    "bce_with_logits",
    "class_balanced_loss",
    "class_balanced_weights",
    "classification_term",
    "compute_class_distribution",
    "contrastive_loss",
    "focal_loss",
    "simplified_combined_loss",
    "triplet_loss",
]
