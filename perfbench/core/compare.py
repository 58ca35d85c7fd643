"""The comparisons that decide `correct`. Each returns {name: (number,
limit)}; a run is correct when every number is at or under its limit (a
NaN is not)."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

Checks = Dict[str, Tuple[float, float]]


def verdicts(means: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(y, y_val) of per-video means [V, 2], as pred_func.py makes them:
    the larger mean's class; y_val mean[0] where class 0 wins, else
    |1 - mean[1]|."""
    y = (means[:, 1] > means[:, 0]).astype(np.int64)
    return y, np.where(y == 0, means[:, 0], np.abs(1.0 - means[:, 1]))


def verdict_numbers(y: np.ndarray, y_val: np.ndarray, ref_means: np.ndarray
                    ) -> Dict[str, float]:
    """Served or scored verdicts against the reference's per-video means
    [V, 2] (class 0, class 1). Each video's y_val is judged against the
    reference's y_val for the class the program chose (pred_func.py:
    mean[0] where class 0 wins, else |1 - mean[1]|): a verdict that flips on
    a near tie does not read as the distance of the two means, while a
    class altered alone still does.

    The gaps are taken in log-odds, logit(y_val) - logit(reference), so
    that a sample whose sigmoids sit near 0 or 1 (as some seeds' weights
    put them) reads its errors at the scale of the logits that made them.
    yval_logit_sd: the spread of the signed gaps about their mean (rounding
    moves each video its own way, a coarser path moves them all more);
    yval_logit_max: the widest (one answer altered). A cell's limits name
    the ones it compares."""
    y = np.asarray(y, np.int64)
    m0, m1 = ref_means[:, 0].astype(np.float64), ref_means[:, 1].astype(np.float64)
    ref_val = np.where(y == 0, m0, np.abs(1.0 - m1))
    val = np.asarray(y_val, np.float64)
    if not len(val):
        return dict.fromkeys(("yval_logit_sd", "yval_logit_max"), math.nan)
    signed = _logit(val) - _logit(ref_val)
    return {"yval_logit_sd": float(signed.std()),
            "yval_logit_max": float(np.abs(signed).max())}


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(p, 1e-7, 1 - 1e-7)
    return np.log(p) - np.log1p(-p)


def held(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Checks:
    """The numbers that have a limit, each beside it."""
    return {k: (float(numbers[k]), float(limits[k])) for k in limits if k in numbers}


def spread(ref_means: np.ndarray) -> str:
    """How decisive the reference's verdicts are: a line for the log."""
    d = np.abs(ref_means[:, 0] - ref_means[:, 1])
    return (f"reference means: class 0 in [{ref_means[:, 0].min():.4f}, "
            f"{ref_means[:, 0].max():.4f}], class 1 in [{ref_means[:, 1].min():.4f}, "
            f"{ref_means[:, 1].max():.4f}], |m0 - m1| median {np.median(d):.4f}, "
            f"min {d.min():.4f}")


def worst_leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
                   leaves: Iterable[str]) -> Tuple[float, str]:
    """max over leaves of |prog norm - ref norm| / max(ref norm, the median
    leaf's ref norm), and the leaf that sets it."""
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    worst, at = 0.0, ""
    for k in leaves:
        d = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not d <= worst:     # NaN wins
            worst, at = d, k
    return worst, at


def moved_leaves(ref_grad: Mapping[str, float], floor: float) -> List[str]:
    """Leaves whose reference gradient norm is at least `floor` times the
    median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= floor * med]


def rel_gaps(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def correct(checks: Checks) -> bool:
    return all(v <= lim for v, lim in checks.values())


def lines(checks: Checks) -> List[str]:
    return [f"check {k}: {v!r} (limit {lim!r})" for k, (v, lim) in checks.items()]
