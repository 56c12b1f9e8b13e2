"""Model evaluation loop and the optimal-threshold search (the port's copy
of ``vae_tagger_tpu/eval/threshold.py``).

``predict_fn(batch) -> probabilities`` (a tensor on any device, or numpy)
serves ``train_full``'s final phase and standalone evaluation alike; one
batch stays in flight, so the card runs batch N+1 while the host copies
batch N's probabilities.  Padded rows are dropped through ``batch_mask``
where a loader sets one.  Under data parallelism (parallel/mesh.py) each
process predicts its slice of every batch; the collection gathers the
probabilities, labels and masks of every process in rank order, so every
process searches and evaluates the global set, and rank 0 alone prints
and writes the files.

Kept from the reference: the threshold search casts weighted labels to int
(``y_true.astype(int)``), so a partial weight below 1.0 counts as 0; the
sweep is 0.1..0.9 in steps of 0.05; the first strict maximum wins and a
class without positives keeps 0.5.  Labels outside {0, 1} after the cast
take the reference's literal per-(class, threshold) F1 sweep, with
sklearn's reading of such labels, errors included (:func:`_sklearn_f1`).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from ..parallel.mesh import gather_to_host, is_main_process
from ..utils.pipelining import OneInFlight
from .metrics import MultiLabelEvaluator, prf


def _host(probs) -> np.ndarray:
    """Probabilities as a float32 numpy array (a tensor is copied off its
    device here, which waits for it)."""
    if hasattr(probs, "detach"):
        probs = probs.detach().float().cpu().numpy()
    return np.asarray(probs, dtype=np.float32)


def collect_predictions(predict_fn: Callable, loader) -> tuple:
    """One full inference pass -> (y_prob, y_true), padding dropped.  Pass
    the result as ``collected=`` to both :func:`find_optimal_threshold` and
    :func:`evaluate_model`, which then share the one pass."""
    probs_all, targets_all = [], []

    def resolve(probs, labels, mask):
        probs = gather_to_host(_host(probs))
        labels = gather_to_host(np.asarray(labels))
        if mask is not None:
            mask = gather_to_host(np.asarray(mask, dtype=bool))
            probs, labels = probs[mask], labels[mask]
        probs_all.append(probs)
        targets_all.append(labels)

    pipeline = OneInFlight(resolve)
    for batch in loader:
        pipeline.submit(predict_fn(batch), batch["labels"],
                        batch.get("batch_mask"))
    pipeline.flush()
    return np.vstack(probs_all), np.vstack(targets_all)


def evaluate_model(predict_fn: Callable, loader, class_names: List[str],
                   threshold: float = 0.5,
                   output_dir: Optional[str] = None,
                   collected: Optional[tuple] = None) -> Dict:
    evaluator = MultiLabelEvaluator(class_names)
    y_prob, y_true = (collected if collected is not None
                      else collect_predictions(predict_fn, loader))
    y_pred = (y_prob > threshold).astype(np.float32)
    evaluator.update(y_pred, y_true, y_prob)
    metrics = evaluator.compute_metrics()
    if not is_main_process():
        return metrics
    evaluator.print_metrics(metrics)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        evaluator.save_metrics(
            metrics, os.path.join(output_dir, "evaluation_results.csv"))
    return metrics


def _f1_table(y_true_int: np.ndarray, y_prob: np.ndarray,
              thresholds: np.ndarray) -> np.ndarray:
    """(T, C) table of binary F1 per (threshold, class): sklearn's
    ``f1_score(pos_label=1, zero_division=0)``, 2 tp / (2 tp + fp + fn),
    whose denominator is |predicted positive| + |actual positive|."""
    pos = y_true_int == 1
    npos = np.count_nonzero(pos, axis=0)
    table = np.empty((len(thresholds), y_prob.shape[1]), dtype=np.float64)
    for t, thr in enumerate(thresholds):
        pred = y_prob > thr
        tp = np.count_nonzero(pred & pos, axis=0)
        denom = np.count_nonzero(pred, axis=0) + npos
        table[t] = np.where(denom > 0, 2.0 * tp / np.maximum(denom, 1), 0.0)
    return table


def _best_by_first_strict_max(f1s: np.ndarray, thresholds: np.ndarray):
    """Reference tie-break: ascending sweep, update only on strictly
    greater F1, starting from (0.5, 0.0) -- the FIRST argmax wins and an
    all-zero row keeps threshold 0.5."""
    best = float(f1s.max()) if len(f1s) else 0.0
    if best <= 0.0:
        return 0.5, 0.0
    return float(thresholds[int(np.argmax(f1s))]), best


def find_optimal_threshold(predict_fn: Callable, loader,
                           class_names: List[str],
                           output_dir: Optional[str] = None,
                           collected: Optional[tuple] = None) -> Dict:
    """Sweep thresholds 0.1..0.9 step 0.05: per-class best-F1 threshold and
    a global best-macro-F1 threshold; writes ``optimal_thresholds.json``."""
    y_prob, y_true = (collected if collected is not None
                      else collect_predictions(predict_fn, loader))
    thresholds = np.arange(0.1, 0.9, 0.05)
    y_true_int = y_true.astype(int)

    if ((y_true_int != 0) & (y_true_int != 1)).any():
        return _find_optimal_threshold_literal(
            y_prob, y_true_int, class_names, thresholds, output_dir)

    table = _f1_table(y_true_int, y_prob, thresholds)  # (T, C)
    has_pos = y_true_int.sum(axis=0) > 0

    optimal: Dict[str, Dict] = {}
    for i, name in enumerate(class_names):
        if has_pos[i]:
            best_thr, best_f1 = _best_by_first_strict_max(
                table[:, i], thresholds)
        else:  # the reference skips the sweep for positive-free classes
            best_thr, best_f1 = 0.5, 0.0
        optimal[name] = {"threshold": best_thr, "f1_score": best_f1}

    # macro F1 averages over ALL classes (positive-free ones contribute 0
    # under zero_division=0), matching table.mean
    best_global_thr, best_global_f1 = _best_by_first_strict_max(
        table.mean(axis=1), thresholds)
    return _emit_threshold_results(optimal, best_global_thr, best_global_f1,
                                   output_dir)


def _target_type(y: np.ndarray) -> str:
    """sklearn's ``type_of_target`` of an int array: "multilabel-indicator"
    for two or more columns of at most two distinct values, else
    "multiclass-multioutput"; one column or a vector: "binary" up to two
    distinct values, else "multiclass"."""
    if y.ndim == 2 and y.shape[1] > 1:
        return ("multilabel-indicator" if np.unique(y).size < 3
                else "multiclass-multioutput")
    return "binary" if np.unique(y).size <= 2 else "multiclass"


def _sklearn_f1(y_true: np.ndarray, y_pred: np.ndarray, average: str
                ) -> float:
    """sklearn's ``f1_score(y_true, y_pred, average=..., zero_division=0)``
    for int labels, including the ValueErrors it raises for labels it
    cannot read that way ("binary" or "macro")."""
    type_true, type_pred = _target_type(y_true), _target_type(y_pred)
    if type_true == type_pred:
        kind = type_true
    elif {type_true, type_pred} == {"binary", "multiclass"}:
        kind = "multiclass"
    else:
        raise ValueError(f"Classification metrics can't handle a mix of "
                         f"{type_true} and {type_pred} targets")
    if kind == "multiclass-multioutput":
        raise ValueError(f"{kind} is not supported")
    if kind == "binary" and np.union1d(y_true, y_pred).size > 2:
        kind = "multiclass"
    if average != "binary":
        return prf(y_true, y_pred, average)["f1"]
    if kind != "binary":
        raise ValueError(f"Target is {kind} but average='binary'. Please "
                         f"choose another average setting, one of "
                         f"{[None, 'micro', 'macro', 'weighted']}.")
    present = np.union1d(y_true, y_pred)
    if 1 not in present and present.size >= 2:
        raise ValueError(f"pos_label=1 is not a valid label. It should be "
                         f"one of {present}")
    t, p = y_true.reshape(-1) == 1, y_pred.reshape(-1) == 1
    denom = t.sum() + p.sum()
    return float(2 * (t & p).sum() / denom) if denom else 0.0


def _find_optimal_threshold_literal(y_prob, y_true_int, class_names,
                                    thresholds, output_dir) -> Dict:
    """The reference's literal per-(class, threshold) sweep, kept for
    label values that sklearn must interpret (:func:`_sklearn_f1`)."""
    optimal: Dict[str, Dict] = {}
    for i, name in enumerate(class_names):
        best_f1, best_thr = 0.0, 0.5
        if y_true_int[:, i].sum() > 0:
            for thr in thresholds:
                y_pred = (y_prob[:, i] > thr).astype(int)
                f1 = _sklearn_f1(y_true_int[:, i], y_pred, "binary")
                if f1 > best_f1:
                    best_f1, best_thr = float(f1), float(thr)
        optimal[name] = {"threshold": best_thr, "f1_score": best_f1}

    best_global_f1, best_global_thr = 0.0, 0.5
    for thr in thresholds:
        y_pred = (y_prob > thr).astype(int)
        f1 = _sklearn_f1(y_true_int, y_pred, "macro")
        if f1 > best_global_f1:
            best_global_f1, best_global_thr = float(f1), float(thr)
    return _emit_threshold_results(optimal, best_global_thr, best_global_f1,
                                   output_dir)


def _emit_threshold_results(optimal: Dict, best_global_thr: float,
                            best_global_f1: float,
                            output_dir: Optional[str]) -> Dict:
    results = {
        "global_threshold": best_global_thr,
        "global_f1": best_global_f1,
        "per_class_thresholds": optimal,
    }
    if not is_main_process():
        return results
    print(f"Global Threshold: {best_global_thr:.3f} "
          f"(Macro F1: {best_global_f1:.4f})")
    print("\nPer-Class Thresholds:")
    for name, info in optimal.items():
        print(f"  {name:<20}: {info['threshold']:.3f} "
              f"(F1: {info['f1_score']:.4f})")
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, "optimal_thresholds.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(results, f, indent=2, ensure_ascii=False)
        print(path)
    return results
