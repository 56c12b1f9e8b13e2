"""Multi-label evaluation metrics in numpy (the port's copy of
``vae_tagger_tpu/eval/metrics.py``, which calls scikit-learn).

The machine with the card has no scikit-learn, so the sklearn metrics that
the JAX package reads are written out here with sklearn's semantics:

- :func:`prf` is ``precision_score`` / ``recall_score`` / ``f1_score`` with
  ``zero_division=0``: a label indicator matrix (two or more columns, at
  most two distinct values) counts every nonzero entry as a positive, per
  column; a single column counts each label value of the union of truth and
  prediction as its own class.  ``f1 = 2 tp / (true + pred)`` (0 where both
  are 0); "micro" sums the counts first, "macro" is the plain mean,
  "weighted" the mean weighted by the true counts (the plain mean where
  they are all 0).
- :func:`average_precision` is ``average_precision_score``: per column,
  sum over the distinct scores (descending) of (R_n - R_{n-1}) P_n, so tied
  scores form one step; a column without positives scores 0; "micro"
  ravels, "macro" is the mean, "weighted" the mean weighted by the column's
  positives, 0 when there are none.

``MultiLabelEvaluator`` keeps the JAX class's interface and outputs: subset
accuracy, Hamming loss, the nine P/R/F1 averages, the three mAPs, the
per-class table with its degenerate-class branches, and ``save_metrics``
(``*_overall.json`` and the per-class CSV, through pandas where it is
installed and in the same text without it).
"""

from __future__ import annotations

import csv
import json
from typing import Dict, List, Optional

import numpy as np


# --------------------------------------------------------------------------
# sklearn's classification metrics
# --------------------------------------------------------------------------

def _counts(y_true, y_pred):
    """(tp, pred, true) per class as int arrays, with sklearn's reading of
    the targets: an indicator matrix per column (nonzero = positive), a
    single column per label value."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.ndim == 2 and y_true.shape[1] > 1:
        t, p = y_true != 0, y_pred != 0
        return ((t & p).sum(axis=0), p.sum(axis=0), t.sum(axis=0))
    t, p = y_true.reshape(-1), y_pred.reshape(-1)
    labels = np.union1d(t, p)
    return (np.array([np.sum((t == v) & (p == v)) for v in labels]),
            np.array([np.sum(p == v) for v in labels]),
            np.array([np.sum(t == v) for v in labels]))


def _divide(num, den):
    """num / den as float64, 0 where den is 0 (``zero_division=0``)."""
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))


def _average(values, weights=None) -> float:
    if weights is not None and np.sum(weights) != 0:
        return float(np.average(values, weights=weights))
    return float(np.mean(values))


def prf(y_true, y_pred, average: str) -> Dict[str, float]:
    """{"precision", "recall", "f1"} of a "micro", "macro" or "weighted"
    average, as sklearn's scores with ``zero_division=0``."""
    tp, pred, true = _counts(y_true, y_pred)
    if average == "micro":
        tp, pred, true = (np.array([a.sum()]) for a in (tp, pred, true))
    elif average not in ("macro", "weighted"):
        raise ValueError(f"unknown average {average!r}")
    weights = true if average == "weighted" else None
    return {"precision": _average(_divide(tp, pred), weights),
            "recall": _average(_divide(tp, true), weights),
            "f1": _average(_divide(2 * tp, true + pred), weights)}


def binary_prf(y_true, y_pred) -> Dict[str, float]:
    """sklearn's binary P/R/F1 (``pos_label=1``, ``zero_division=0``) of
    one label column that holds 0 and 1."""
    t, p = np.asarray(y_true) == 1, np.asarray(y_pred) == 1
    tp, pred, true = (t & p).sum(), p.sum(), t.sum()
    return {"precision": float(_divide(tp, pred)),
            "recall": float(_divide(tp, true)),
            "f1": float(_divide(2 * tp, true + pred))}


def binary_average_precision(y_true, y_score) -> float:
    """sklearn's ``average_precision_score`` of one 0/1 column: the
    precision-recall curve over the distinct scores, then
    ``max(0, -sum(diff(recall) * precision[:-1]))``."""
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    if not (np.isfinite(y_true).all() and np.isfinite(y_score).all()):
        raise ValueError("Input contains NaN or infinity.")
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[order]
    hits = (y_true[order] == 1).astype(np.float64)
    idx = np.concatenate([np.nonzero(np.diff(y_score))[0], [hits.size - 1]])
    tps = np.cumsum(hits)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
    recall = (np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1])
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def average_precision(y_true, y_score, average: str) -> float:
    """sklearn's ``average_precision_score`` of a 0/1 indicator matrix;
    a single column is one binary problem."""
    y_true, y_score = np.asarray(y_true), np.asarray(y_score)
    if y_true.ndim == 1 or y_true.shape[1] == 1:
        return binary_average_precision(y_true, y_score)
    if average == "micro":
        return binary_average_precision(y_true.ravel(), y_score.ravel())
    weights = None
    if average == "weighted":
        weights = y_true.sum(axis=0)
        if np.isclose(weights.sum(), 0):
            return 0.0
    elif average != "macro":
        raise ValueError(f"unknown average {average!r}")
    scores = np.array([binary_average_precision(y_true[:, c], y_score[:, c])
                       for c in range(y_true.shape[1])])
    if weights is not None:
        scores[weights == 0] = 0.0
        return float(np.average(scores, weights=weights))
    return float(np.mean(scores))


# --------------------------------------------------------------------------
# the evaluator
# --------------------------------------------------------------------------

class MultiLabelEvaluator:
    def __init__(self, class_names: Optional[List[str]] = None):
        self.class_names = class_names
        self.reset_metrics()

    def reset_metrics(self):
        self.all_predictions: List[np.ndarray] = []
        self.all_targets: List[np.ndarray] = []
        self.all_probabilities: List[np.ndarray] = []

    def update(self, predictions, targets, probabilities=None):
        self.all_predictions.append(np.asarray(predictions))
        self.all_targets.append(np.asarray(targets))
        if probabilities is not None:
            self.all_probabilities.append(np.asarray(probabilities))

    def compute_metrics(self) -> Dict:
        if not self.all_targets:
            raise ValueError("update() was never called")
        # weighted labels (tag:0.8) are binarized, as the JAX package does
        y_true = (np.vstack(self.all_targets) > 0).astype(np.float32)
        y_pred = np.vstack(self.all_predictions)
        y_prob = (np.vstack(self.all_probabilities)
                  if self.all_probabilities else y_pred)

        metrics: Dict = {}
        metrics["accuracy"] = float((y_true == y_pred).all(axis=1).mean())
        metrics["hamming_loss"] = float((y_true != y_pred).mean())
        for average in ("micro", "macro", "weighted"):
            for name, value in prf(y_true, y_pred, average).items():
                metrics[f"{name}_{average}"] = value
        try:
            metrics["mAP"] = average_precision(y_true, y_prob, "macro")
            metrics["mAP_micro"] = average_precision(y_true, y_prob, "micro")
            metrics["mAP_weighted"] = average_precision(y_true, y_prob,
                                                        "weighted")
        except ValueError as e:
            print(f"mAP: {e}")
            metrics["mAP"] = metrics["mAP_micro"] = metrics["mAP_weighted"] = 0.0
        metrics["per_class"] = self._per_class(y_true, y_pred, y_prob)
        return metrics

    def _per_class(self, y_true, y_pred, y_prob) -> Dict:
        per_class: Dict = {}
        for i in range(y_true.shape[1]):
            name = (self.class_names[i] if self.class_names else f"Class_{i}")
            support = int(y_true[:, i].sum())
            if support == 0:
                per_class[name] = dict(precision=0.0, recall=0.0, f1=0.0,
                                       ap=0.0, support=0)
            elif support == len(y_true):
                # all-positive class: recall/AP are trivially 1
                p = float((y_pred[:, i] == 1).mean())
                f1 = 2 * p / (1 + p) if (y_pred[:, i] == 1).sum() > 0 else 0.0
                per_class[name] = dict(precision=p, recall=1.0, f1=f1,
                                       ap=1.0, support=support)
            else:
                try:
                    scores = binary_prf(y_true[:, i], y_pred[:, i])
                    per_class[name] = dict(
                        scores, ap=binary_average_precision(y_true[:, i],
                                                            y_prob[:, i]),
                        support=support)
                except ValueError as e:
                    print(f"{name}: {e}")
                    per_class[name] = dict(precision=0.0, recall=0.0,
                                           f1=0.0, ap=0.0, support=support)
        return per_class

    def print_metrics(self, metrics: Dict, detailed: bool = True):
        print(f"  Subset Accuracy: {metrics['accuracy']:.4f}")
        print(f"  Hamming Loss:    {metrics['hamming_loss']:.4f}")
        for metric_type in ("precision", "recall", "f1"):
            print(f"  {metric_type.capitalize()}:")
            for avg in ("micro", "macro", "weighted"):
                print(f"    {avg}: {metrics[f'{metric_type}_{avg}']:.4f}")
        print("\n mAP (mean Average Precision):")
        print(f"   Macro:    {metrics['mAP']:.4f}")
        print(f"   Micro:    {metrics['mAP_micro']:.4f}")
        print(f"   Weighted: {metrics['mAP_weighted']:.4f}")
        if detailed and "per_class" in metrics:
            print(f"{'':<20} {'Precision':<10} {'Recall':<10} {'F1':<10} "
                  f"{'AP':<10} {'Support':<10}")
            for name, m in metrics["per_class"].items():
                print(f"{name:<20} {m['precision']:<10.4f} "
                      f"{m['recall']:<10.4f} {m['f1']:<10.4f} "
                      f"{m['ap']:<10.4f} {m['support']:<10}")

    def save_metrics(self, metrics: Dict, output_path: str):
        """CSV for per-class + ``*_overall.json`` for the scalar metrics."""
        overall = {k: v for k, v in metrics.items() if k != "per_class"}
        with open(output_path.replace(".csv", "_overall.json"), "w",
                  encoding="utf-8") as f:
            json.dump(overall, f, indent=2, ensure_ascii=False)
        if "per_class" in metrics:
            write_per_class_csv(metrics["per_class"], output_path)
            print(f"per-class metrics saved to: {output_path}")


def write_per_class_csv(per_class: Dict, path: str) -> None:
    """``pd.DataFrame(per_class).T.to_csv(path)`` with the index named
    ``class_name``; the same text through the csv module where pandas is
    not installed (every column then holds floats, as the transposed frame
    does)."""
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None:
        df = pd.DataFrame(per_class).T
        df.index.name = "class_name"
        df.to_csv(path)
        return
    columns = []
    for row in per_class.values():
        columns += [k for k in row if k not in columns]
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["class_name", *columns])
        for name, row in per_class.items():
            writer.writerow([name, *("" if k not in row else
                                     repr(float(row[k])) for k in columns)])
