"""Accuracy / ROC-AUC / F1 from result JSONs and the combined ROC plot (the
repository's `result_all.py`, ref result_all.py:6-75), in numpy
(evalx/metrics.py); the plot needs matplotlib (evalx/plots.py):

    python -m genconvit_tpu_torch.result_all [result/a.json result/b.json ...]

Defaults to every prediction_*.json / data_*.json under result/.
"""

from __future__ import annotations

import glob
import sys
from typing import List, Optional

from genconvit_tpu_torch.evalx.metrics import load_result, result_metrics
from genconvit_tpu_torch.evalx.plots import plot_roc


def main(argv: Optional[List[str]] = None) -> None:
    paths = (sys.argv[1:] if argv is None else argv) or sorted(
        glob.glob("result/data_*.json") + glob.glob("result/prediction_*.json"))
    if not paths:
        print("no result files found under result/")
        return
    for p in paths:
        try:
            m = result_metrics(load_result(p))
        except (KeyError, ValueError) as e:
            print(f"{p}: skipped ({e})")
            continue
        print(f"== {p} ==")
        print(f"  n={m['n']} (real {m['n_real']} / fake {m['n_fake']})")
        print(f"  accuracy:      {m['accuracy']:.4f}")
        print(f"  real accuracy: {m['real_accuracy']:.4f}")
        print(f"  fake accuracy: {m['fake_accuracy']:.4f}")
        if "roc_auc" in m:
            print(f"  roc_auc:       {m['roc_auc']:.4f}")
            print(f"  f1:            {m['f1']:.4f}")
    out = plot_roc(paths, "result/roc_all.png")
    print(f"ROC plot written to {out}")


if __name__ == "__main__":
    main()
