"""A/B benchmark runner of the PyTorch/CUDA port, the repository's
`run_benchmark.sh` (:1-23) in-process:

    python -m genconvit_tpu_torch.run_benchmark [DATA_DIR] [FRAMES] [OUT_DIR] [FLAGS...]

DATA_DIR, FRAMES and OUT_DIR default to sample_prediction_data, 10 and
result/benchmark. `prediction_v2` runs over DATA_DIR with --arch-type
original, then v2, each writing its result JSON into OUT_DIR, then
`plot_comparison` compares OUT_DIR/prediction_*.json (every run's there, as
the script's glob takes them) into OUT_DIR. FLAGS, every argument from the
first one that starts with '-', go to both prediction_v2 runs (e.g.
`--device cpu --face-backend center --weights-dir weight`). The steps run in
this process, so a caller's substitutions (the decoder) hold in both runs.
Any failure ends the run with a non-zero exit, as `set -euo pipefail` does;
the comparison needs matplotlib (its ImportError propagates).
"""

from __future__ import annotations

import glob
import logging
import os
import sys
from typing import Any, Dict, List, Optional

from genconvit_tpu_torch import plot_comparison, prediction_v2

DEFAULTS = ("sample_prediction_data", "10", "result/benchmark")
ARCH_TYPES = ("original", "v2")


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the A/B workflow on argv (sys.argv[1:] by default); returns
    {"runs": {arch_type: result JSON path}, "artifacts": the comparison's}."""
    rest = list(sys.argv[1:] if argv is None else argv)
    if rest[:1] in (["-h"], ["--help"]):
        print(__doc__)
        return {}
    pos: List[str] = []
    while rest and len(pos) < len(DEFAULTS) and not rest[0].startswith("-"):
        pos.append(rest.pop(0))
    data_dir, frames, out_dir = pos + list(DEFAULTS[len(pos):])
    os.makedirs(out_dir, exist_ok=True)
    runs = {}
    for i, arch in enumerate(ARCH_TYPES, 1):
        print(f"== run {i}: {arch} ==", flush=True)
        runs[arch] = prediction_v2.main(["--p", data_dir, "--f", frames, "--arch-type", arch,
                                         "--result-dir", out_dir] + rest)
    print("== comparison ==", flush=True)
    results = sorted(glob.glob(os.path.join(out_dir, "prediction_*.json")))
    artifacts = plot_comparison.main(results + ["--out-dir", out_dir])
    return {"runs": runs, "artifacts": artifacts}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
