#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

With --trace 0 the result's metrics are the cell's end-to-end metrics; with
--trace 1 its per-layer metrics, read from a traced slice after the window.
Exits non-zero, and prints no result, without enough CUDA devices, when the
port cannot be imported, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "genconvit_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name only begins with the latter)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
             fp8_control: bool = False):
    """Drive the cell once: the driver its traffic mix names. fp8_control
    judges the control in the program's place (`control.py`, the tests)."""
    from perfbench.core import registry
    from perfbench.core.cell import Context

    driver = registry.module("drivers", cell["traffic"]["driver"])
    return driver.run(Context(cell, seed, seconds, trace, device, t0, fp8_control))


def result_line(bench: dict, cell: dict, outcome, trace: bool, device_info: dict) -> dict:
    """The result's JSON object: the cell's metrics, then the device, the
    breakdown of a traced run, and the compared numbers last."""
    from perfbench.core import compare, registry
    from perfbench.core import trace as tr

    metrics = {}
    for m in registry.cell_metrics(bench, cell["name"], trace):
        if trace:
            value = registry.reader(m["name"]).read(outcome.readings)
        else:   # `videos_per_s.large` is the driver's `videos_per_s` under a bound of its own
            value = outcome.end_to_end.get(m["name"], outcome.end_to_end.get(
                m["name"].split(".")[0]))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": compare.correct(outcome.checks), "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": dict(device_info)}
    summary = outcome.readings.trace
    if trace and summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": tr.by_group(summary.kernels, outcome.group),
                            "idle_gaps": tr.gaps_by_host(summary.gaps)}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench.core import compare, registry

    bench = registry.benchmark()
    cell = registry.cell(args.workload)
    chips = registry.chips(bench, args.workload) or 1
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import genconvit_tpu_torch  # noqa: F401  (fails where the checkout lacks the port)

    print(f"[{time.perf_counter() - T0:8.2f}s] torch {torch.__version__} imported, "
          f"{torch.cuda.get_device_name(0)}", file=sys.stderr, flush=True)

    dev = torch.device("cuda", 0)
    outcome = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, T0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": outcome.readings.memory_peak_bytes}
    line = result_line(bench, cell, outcome, bool(args.trace), info)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for text in compare.lines(outcome.checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
