"""Result-JSON schemas (copy of genconvit_tpu/infer/result.py, the same
keys byte for byte).

v1: the reference's bare schema (ref model/pred_func.py:158-184), read by
result_all.py-style analysis. v2: a superset with `metrics` and `metadata`
blocks (ref prediction_v2.py:429-515, docs/comparison_tools.md:77-105).
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Dict, List, Optional

from genconvit_tpu_torch.infer.aggregate import real_or_fake


def set_result() -> Dict[str, Any]:
    return {
        "video": {
            "name": [],
            "pred": [],
            "klass": [],
            "pred_label": [],
            "correct_label": [],
        }
    }


def store_result(result: Dict[str, Any], filename: str, y: int, y_val: float,
                 klass: str, correct_label: Optional[str] = None,
                 compression: Optional[str] = None) -> Dict[str, Any]:
    result["video"]["name"].append(filename)
    result["video"]["pred"].append(float(y_val))
    result["video"]["klass"].append(klass.lower())
    result["video"]["pred_label"].append(real_or_fake(y))
    if correct_label is not None:
        result["video"]["correct_label"].append(correct_label)
    if compression is not None:
        result["video"].setdefault("compression", []).append(compression)
    return result


def compute_metrics(y_true: List[int], y_pred: List[int]) -> Dict[str, float]:
    """sklearn accuracy/precision/recall/F1 (ref prediction_v2.py:41-46)."""
    from sklearn.metrics import (accuracy_score, f1_score, precision_score,
                                 recall_score)

    if not y_true:
        return {}
    return {
        "accuracy": float(accuracy_score(y_true, y_pred)),
        "precision": float(precision_score(y_true, y_pred, zero_division=0)),
        "recall": float(recall_score(y_true, y_pred, zero_division=0)),
        "f1": float(f1_score(y_true, y_pred, zero_division=0)),
    }


def attach_metrics(result: Dict[str, Any], y_true: List[int],
                   y_pred: List[int]) -> Dict[str, Any]:
    result["metrics"] = compute_metrics(y_true, y_pred)
    return result


def attach_metadata(result: Dict[str, Any], *, dataset: str, net: str,
                    num_frames: int, runtime_seconds: float,
                    extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    result["metadata"] = {
        "dataset": dataset,
        "network": net,
        "num_frames": num_frames,
        "runtime_seconds": runtime_seconds,
        "timestamp": datetime.now().isoformat(),
        "framework": "genconvit_tpu_torch",
        **(extra or {}),
    }
    return result


def result_path(result_dir: str, dataset: str, net: str) -> str:
    ts = datetime.now().strftime("%B_%d_%Y_%H_%M_%S")
    return os.path.join(result_dir, f"prediction_{dataset}_{net}_{ts}.json")


def write_result(result: Dict[str, Any], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f)
    return path
