"""Find a cell's files by name. Adding a cell, a configuration, a traffic mix,
a driver or a per-layer metric adds a file and needs no edit here:

  workloads/<cell>.json    the cell's own parameters: {"config", "traffic", ...}; an
                           "init" block there overrides the configuration's
  configs/<config>.json    the model's sizes, dtype and kernel plan
  traffic/<traffic>.json   the mix's parameters; its "driver" names drivers/<driver>.py
  metrics/<metric>.py      a per-layer metric's reader: read(readings) -> float | None;
                           where there is none, the reader of the name's part before
                           its first dot (`device_idle.serve` -> `device_idle.py`)

Which metrics a cell reports comes from BENCHMARK.json at the checkout's
root: every metric whose `workloads` lists the cell, or that has none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load(kind: str, name: str, bench_dir: str = BENCH_DIR) -> Dict[str, Any]:
    """The JSON file `<kind>/<name>.json` under the benchmark's folder."""
    path = os.path.join(bench_dir, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return _json(path)


def module(kind: str, name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """The Python file `<kind>/<name>.py` (names may hold dots)."""
    path = os.path.join(bench_dir, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """A per-layer metric's reader: `metrics/<name>.py`, or else the one of
    the name's part before its first dot."""
    own = os.path.join(bench_dir, "metrics", name + ".py")
    return module("metrics", name if os.path.isfile(own) else name.split(".")[0], bench_dir)


def cell(name: str, bench_dir: str = BENCH_DIR) -> Dict[str, Any]:
    """The cell with its configuration and traffic mix loaded:
    {"name", "workload", "config", "traffic"}. The workload's "init" block,
    if any, overrides the configuration's (how the random weights are made)."""
    wl = load("workloads", name, bench_dir)
    cfg = load("configs", wl["config"], bench_dir)
    if "init" in wl:
        cfg["init"] = {**cfg["init"], **wl["init"]}
    return {"name": name, "workload": wl, "config": cfg,
            "traffic": load("traffic", wl["traffic"], bench_dir)}


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return _json(path)


def _applies(metric: Dict[str, Any], cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell_metrics(bench: Dict[str, Any], cell_name: str, trace: bool) -> List[Dict[str, Any]]:
    """The end-to-end metrics (trace off) or the per-layer ones (trace on)
    that BENCHMARK.json gives the cell."""
    return [m for m in bench["per_layer" if trace else "end_to_end"] if _applies(m, cell_name)]


def chips(bench: Dict[str, Any], cell_name: str) -> Optional[int]:
    for w in bench["workloads"]:
        if w["name"] == cell_name:
            return int(w["chips"])
    return None
