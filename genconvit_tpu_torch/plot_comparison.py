"""Compare result JSONs across runs: bar charts, confusion matrices, CSV and
a text summary (the repository's `plot_comparison.py`, ref
plot_comparison.py:12-207); needs matplotlib (evalx/plots.py):

    python -m genconvit_tpu_torch.plot_comparison result/a.json result/b.json [--out-dir DIR]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from genconvit_tpu_torch.evalx.plots import plot_metrics_comparison


def main(argv: Optional[List[str]] = None) -> Dict[str, str]:
    p = argparse.ArgumentParser("plot_comparison")
    p.add_argument("results", nargs="+", help="result JSON files")
    p.add_argument("--out-dir", default="result/comparison")
    args = p.parse_args(argv)
    artifacts = plot_metrics_comparison(args.results, args.out_dir)
    for k, v in artifacts.items():
        print(f"{k}: {v}")
    return artifacts


if __name__ == "__main__":
    main()
