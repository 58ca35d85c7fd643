#!/usr/bin/env python3
"""Readings that set a cell's limits and rate, several runs in one process
(the kernel library builds once):

    python3 perfbench/control.py --workload NAME --seeds 1,2,3 --seconds 3 [--control]
    python3 perfbench/control.py --workload NAME --seeds 1 --seconds 8 --rates 40,80,120

Each run prints one JSON line: the seed, the compared numbers and the
end-to-end metrics. --control judges the reference computed from float8
operands in the program's place (the comparison's control); --fault
half_batch plants that fault in a training cell's step. --rates runs a
serving cell at each offered rate in turn (the knee sweep) and adds how
far the run fell behind: completed requests per second and the median
latency of each half of the window.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import run as bench_run  # noqa: E402


def half_batch(make_train_step):
    """`make_train_step` whose steps drop the second half of their batch,
    labels and eps: the mean taken over the rest (a fault the comparison
    must catch; the tests plant the same)."""
    def make(*a, **k):
        step = make_train_step(*a, **k)
        return lambda x, y, eps=None: step(x[: len(x) // 2], y[: len(y) // 2],
                                           None if eps is None else eps[: len(eps) // 2])

    return make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true",
                    help="judge the reference from float8 operands in the program's place")
    ap.add_argument("--rates", default="")
    ap.add_argument("--fault", choices=("half_batch",), default=None,
                    help="half_batch: the training step takes half of each batch, the mean "
                         "over the rest (a fault the comparison must catch)")
    args = ap.parse_args(argv)
    import torch

    from perfbench.core import registry

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.fault == "half_batch":
        from genconvit_tpu_torch.train import loop

        loop.make_train_step = half_batch(loop.make_train_step)
    cell = registry.cell(args.workload)
    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    for seed in [int(s) for s in args.seeds.split(",")]:
        for rate in rates:
            if rate is not None:
                cell["workload"]["rate_per_s"] = rate
            t = time.perf_counter()
            out = bench_run.run_cell(cell, seed, args.seconds, False, dev, t,
                                     fp8_control=args.control)
            row = {"workload": args.workload, "seed": seed, "control": args.control,
                   "numbers": out.numbers,
                   "metrics": out.end_to_end, "attempted": out.attempted,
                   "failed": out.failed, "window": out.readings.window,
                   "peak_gib": out.readings.memory_peak_bytes / 2 ** 30}
            if rate is not None:
                row["rate"] = rate
                row.update(out.readings.window.get("sweep", {}))
            print(json.dumps(row, default=lambda x: None if isinstance(x, float)
                             and math.isnan(x) else str(x)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
