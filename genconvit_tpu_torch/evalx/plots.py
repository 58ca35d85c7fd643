"""Plot/report tooling (port of genconvit_tpu/evalx/plots.py:15-118): the
reference's result_all.py ROC plot and plot_comparison.py bar charts,
confusion matrices and CSV summary (ref plot_comparison.py:12-207), and
evaluate's confusion-matrix figure (evaluate.py:84-100 of the repository).

matplotlib is imported when a plot is drawn (`_plt`), never at import: a
host without it (the card host has none) raises ImportError from the
`plot_*` call, and nothing on the device path calls one."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from genconvit_tpu_torch.evalx.metrics import load_result, result_metrics, result_vectors, roc_points


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_roc(paths: List[str], out_path: str = "roc.png",
             labels: Optional[List[str]] = None) -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 6))
    for i, p in enumerate(paths):
        result = load_result(p)
        try:
            fpr, tpr, auc = roc_points(result)
        except ValueError:
            continue
        name = labels[i] if labels else os.path.basename(p)
        ax.plot(fpr, tpr, label=f"{name} (AUC {auc:.4f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title("ROC — P(fake) scores")
    ax.legend(loc="lower right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_metrics_comparison(paths: List[str], out_dir: str = ".") -> Dict[str, str]:
    """Bar chart of accuracy/precision-style metrics + per-run confusion
    matrices + CSV summary. Returns {artifact: path}."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    artifacts: Dict[str, str] = {}

    names, rows = [], []
    for p in paths:
        m = result_metrics(load_result(p))
        names.append(os.path.splitext(os.path.basename(p))[0])
        rows.append(m)

    metric_keys = ["accuracy", "real_accuracy", "fake_accuracy", "roc_auc", "f1"]
    fig, ax = plt.subplots(figsize=(9, 5))
    x = np.arange(len(names))
    width = 0.15
    for j, key in enumerate(metric_keys):
        vals = [r.get(key, float("nan")) for r in rows]
        ax.bar(x + (j - 2) * width, vals, width, label=key)
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=20, ha="right", fontsize=8)
    ax.set_ylim(0, 1.05)
    ax.legend(fontsize=8)
    ax.set_title("Run comparison")
    fig.tight_layout()
    bar_path = os.path.join(out_dir, "metrics_comparison.png")
    fig.savefig(bar_path, dpi=120)
    plt.close(fig)
    artifacts["bar_chart"] = bar_path

    # confusion matrices
    fig, axes = plt.subplots(1, max(len(paths), 1), figsize=(4 * len(paths), 4),
                             squeeze=False)
    for i, p in enumerate(paths):
        y_true, y_pred, _ = result_vectors(load_result(p))
        cm = np.zeros((2, 2), int)
        for t, q in zip(y_true, y_pred):
            cm[t, q] += 1
        ax = axes[0][i]
        ax.imshow(cm, cmap="Blues")
        for r in range(2):
            for c in range(2):
                ax.text(c, r, str(cm[r, c]), ha="center", va="center")
        ax.set_xticks([0, 1], ["REAL", "FAKE"])
        ax.set_yticks([0, 1], ["REAL", "FAKE"])
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        ax.set_title(names[i], fontsize=8)
    fig.tight_layout()
    cm_path = os.path.join(out_dir, "confusion_matrices.png")
    fig.savefig(cm_path, dpi=120)
    plt.close(fig)
    artifacts["confusion"] = cm_path

    csv_path = os.path.join(out_dir, "metrics_summary.csv")
    with open(csv_path, "w") as f:
        f.write("run," + ",".join(metric_keys) + ",n,n_real,n_fake\n")
        for name, r in zip(names, rows):
            vals = [f"{r.get(k, float('nan')):.4f}" for k in metric_keys]
            f.write(f"{name}," + ",".join(vals) +
                    f",{r['n']},{r['n_real']},{r['n_fake']}\n")
    artifacts["csv"] = csv_path

    txt_path = os.path.join(out_dir, "summary_report.txt")
    with open(txt_path, "w") as f:
        for name, r in zip(names, rows):
            f.write(f"== {name} ==\n")
            for k, v in r.items():
                f.write(f"  {k}: {v}\n")
    artifacts["report"] = txt_path
    return artifacts


def plot_confusion_matrix(cm: np.ndarray, classes: List[str], out_path: str) -> str:
    """evaluate's figure: the counts over a blue map, classes on both axes."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.imshow(cm, cmap="Blues")
    for r in range(cm.shape[0]):
        for c in range(cm.shape[1]):
            ax.text(c, r, str(cm[r, c]), ha="center", va="center")
    ax.set_xticks(range(len(classes)), classes)
    ax.set_yticks(range(len(classes)), classes)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
