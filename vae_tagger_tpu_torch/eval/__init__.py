from .metrics import MultiLabelEvaluator
from .threshold import (
    collect_predictions,
    evaluate_model,
    find_optimal_threshold,
)

__all__ = [
    "MultiLabelEvaluator",
    "collect_predictions",
    "evaluate_model",
    "find_optimal_threshold",
]
