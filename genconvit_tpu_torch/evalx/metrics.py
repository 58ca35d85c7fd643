"""Offline metric derivation from result JSONs (port of
genconvit_tpu/evalx/metrics.py:18-74) and the scores `evaluate` prints,
in numpy: no sklearn, which the card host does not have.

The JAX package calls sklearn; these functions give its numbers. Labels
FAKE->1 from pred_label/correct_label, ROC-AUC over video['pred'] treated
as P(fake) (a pseudo-probability, SURVEY.md §8 B3), F1 at the 0.5
threshold, real/fake/total accuracies. Precision, recall and F1 take
sklearn's `zero_division=0` (a ratio with a zero denominator is 0);
`roc_curve` drops the intermediate collinear points as sklearn's default
does, and the AUC is the trapezoid under it, so tied scores count half.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------- scores

def confusion_matrix(y_true, y_pred, labels: Optional[Sequence[int]] = None) -> np.ndarray:
    """[n, n] counts, rows true, columns predicted, over `labels` (by
    default the sorted labels present in either vector)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred])) if labels is None else np.asarray(labels)
    index = {int(v): i for i, v in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def _ratio(num, den) -> np.ndarray:
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den > 0)


def _counts(y_true, y_pred, labels) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per label: true positives, predictions and true samples. A sample
    whose label is not in `labels` still counts as a false positive of the
    label it was given."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return (np.array([np.sum((y_true == l) & (y_pred == l)) for l in labels], np.int64),
            np.array([np.sum(y_pred == l) for l in labels], np.int64),
            np.array([np.sum(y_true == l) for l in labels], np.int64))


def precision_recall_f1(y_true, y_pred, labels: Sequence[int]
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per label: precision, recall, F1 (2 tp / (2 tp + fp + fn)) and
    support, zero where undefined."""
    tp, pred_sum, true_sum = _counts(y_true, y_pred, labels)
    return (_ratio(tp, pred_sum), _ratio(tp, true_sum), _ratio(2 * tp, pred_sum + true_sum),
            true_sum)


def binary_scores(y_true, y_pred) -> Dict[str, float]:
    """accuracy, and precision/recall/F1 of class 1, as sklearn's
    accuracy_score and precision/recall/f1_score(zero_division=0)."""
    p, r, f1, _ = precision_recall_f1(y_true, y_pred, [1])
    return {"accuracy": float(np.mean(np.asarray(y_true) == np.asarray(y_pred))),
            "precision": float(p[0]), "recall": float(r[0]), "f1": float(f1[0])}


def classification_report(y_true, y_pred, labels: Optional[Sequence[int]] = None,
                          target_names: Optional[Sequence[str]] = None,
                          digits: int = 2) -> str:
    """The text of sklearn's classification_report(..., zero_division=0):
    a row per label, then accuracy (where `labels` covers every label
    present), macro and weighted averages."""
    present = np.unique(np.concatenate([np.asarray(y_true), np.asarray(y_pred)]))
    given = labels is not None
    labels = np.asarray(labels) if given else present
    if target_names is not None and len(labels) != len(target_names) and not given:
        raise ValueError(f"Number of classes, {len(labels)}, does not match size of "
                         f"target_names, {len(target_names)}. Try specifying the labels "
                         "parameter")
    names = list(target_names) if target_names is not None else [str(l) for l in labels]
    p, r, f1, s = precision_recall_f1(y_true, y_pred, labels)
    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    report = ("{:>{width}s} " + " {:>9}" * 4).format("", *headers, width=width) + "\n\n"
    for row in zip(names, p, r, f1, s):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    total = int(np.sum(s))
    if not given or set(labels.tolist()) >= set(present.tolist()):
        acc = float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))
        report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f} {:>9}\n").format(
            "accuracy", "", "", acc, total, width=width, digits=digits)
    else:   # sklearn's micro average over `labels`
        tp, pred_sum, true_sum = (c.sum() for c in _counts(y_true, y_pred, labels))
        report += row_fmt.format("micro avg", float(_ratio(tp, pred_sum)),
                                 float(_ratio(tp, true_sum)),
                                 float(_ratio(2 * tp, pred_sum + true_sum)), total,
                                 width=width, digits=digits)
    report += row_fmt.format("macro avg", p.mean(), r.mean(), f1.mean(), total,
                             width=width, digits=digits)
    avg = [float(np.average(v, weights=s)) if total else 0.0 for v in (p, r, f1)]
    report += row_fmt.format("weighted avg", *avg, total, width=width, digits=digits)
    return report


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sklearn's roc_curve(drop_intermediate=True) with class 1 positive:
    (fpr, tpr, thresholds), thresholds falling from inf; fpr (tpr) is all
    NaN where there is no negative (positive) sample."""
    y_true, y_score = np.asarray(y_true), np.asarray(y_score, np.float64)
    if y_true.size == 0:
        raise ValueError("roc_curve: no samples")
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, pos = y_score[order], (y_true[order] == 1).astype(np.float64)
    last = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]   # each distinct score's last index
    tps = np.cumsum(pos)[last]
    fps = 1 + last - tps
    thresholds = y_score[last]
    if fps.shape[0] > 2:   # drop the points collinear with their neighbours
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def roc_auc_score(y_true, y_score) -> float:
    """Area under roc_curve by the trapezoid rule; NaN with one class
    (sklearn warns and returns NaN), ValueError with no sample."""
    y_true = np.asarray(y_true)
    if y_true.size == 0:
        raise ValueError("roc_auc_score: no samples")
    if len(np.unique(y_true)) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


# ---------------------------------------------------------- result JSONs

def load_result(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def result_vectors(result: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(y_true, y_pred, scores) with FAKE == 1. Rows whose correct_label is
    not REAL/FAKE (videos without ground truth) are excluded; result_metrics
    reports their count as n_excluded."""
    video = result["video"]
    keep = [i for i, c in enumerate(video["correct_label"]) if c in ("REAL", "FAKE")]
    y_true = np.array([1 if video["correct_label"][i] == "FAKE" else 0 for i in keep], np.int64)
    y_pred = np.array([1 if video["pred_label"][i] == "FAKE" else 0 for i in keep], np.int64)
    scores = np.array([video["pred"][i] for i in keep], dtype=np.float64)
    return y_true, y_pred, scores


def result_metrics(result: Dict[str, Any]) -> Dict[str, float]:
    y_true, y_pred, scores = result_vectors(result)
    n = len(y_true)
    n_total = len(result["video"]["correct_label"])
    real_mask = y_true == 0
    fake_mask = y_true == 1
    out: Dict[str, float] = {
        "n": int(n),
        "n_excluded": int(n_total - n),
        "n_real": int(real_mask.sum()),
        "n_fake": int(fake_mask.sum()),
        "accuracy": float((y_true == y_pred).mean()) if n else float("nan"),
        "real_accuracy": float((y_pred[real_mask] == 0).mean())
        if real_mask.any() else float("nan"),
        "fake_accuracy": float((y_pred[fake_mask] == 1).mean())
        if fake_mask.any() else float("nan"),
    }
    if real_mask.any() and fake_mask.any():
        out["roc_auc"] = roc_auc_score(y_true, scores)
        out["f1"] = binary_scores(y_true, (scores >= 0.5).astype(np.int64))["f1"]
    return out


def roc_points(result: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray, float]:
    y_true, _, scores = result_vectors(result)
    fpr, tpr, _ = roc_curve(y_true, scores)
    return fpr, tpr, roc_auc_score(y_true, scores)


def summarize(paths: List[str]) -> Dict[str, Dict[str, float]]:
    return {p: result_metrics(load_result(p)) for p in paths}
