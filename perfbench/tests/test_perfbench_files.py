"""Every cell's files are found by name; a new cell needs a file and no edit;
nothing the benchmark runs imports JAX, and its reference nothing of the
port."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.core import registry

BENCH = registry.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "genconvit_tpu"}


def _bench():
    return registry.benchmark()


def test_every_name_resolves():
    bench = _bench()
    for c in bench["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert registry.load("configs", c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = registry.cell(w["name"])
        assert cell["workload"]["config"] == w["config"]
        assert cell["workload"]["traffic"] == w["traffic"]
        assert registry.module("drivers", cell["traffic"]["driver"]).run
        assert registry.chips(bench, w["name"]) == w["chips"] == 1
    for m in bench["per_layer"]:
        assert callable(registry.reader(m["name"]).read)
        for name in m["workloads"]:
            moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
            assert "workloads" not in moved or name in moved["workloads"]


def test_metrics_of_a_cell():
    bench = _bench()
    names = {m["name"] for m in registry.cell_metrics(bench, "tiny_score_v8", False)}
    assert names == {"videos_per_s", "setup_s"}
    per_layer = {m["name"] for m in registry.cell_metrics(bench, "tiny_score_v8", True)}
    assert "k1_roofline.score" in per_layer and "device_idle.serve" not in per_layer
    names = {m["name"] for m in registry.cell_metrics(bench, "large_score_v8", False)}
    assert names == {"videos_per_s.large", "setup_s"}
    names = {m["name"] for m in registry.cell_metrics(bench, "tiny_serve_poisson", False)}
    assert names == {"videos_per_s.serve", "setup_s"}
    per_layer = {m["name"] for m in registry.cell_metrics(bench, "tiny_serve_poisson", True)}
    assert {"latency_p50_ms.serve", "latency_p95_ms.serve", "device_idle.serve"} <= per_layer


def test_readers_by_stem():
    """`device_idle.serve` has no file of its own: `device_idle.py` reads it,
    and every per-layer metric's reader is a file of its stem."""
    assert registry.reader("device_idle.serve") is not None
    with pytest.raises(FileNotFoundError):
        registry.reader("no_such_metric.score")
    for m in _bench()["per_layer"]:
        path = registry.reader(m["name"]).__spec__.origin
        assert os.path.basename(path) == m["name"].split(".")[0] + ".py"


def test_end_to_end_by_stem():
    """A cell's `videos_per_s.large` is its driver's `videos_per_s`."""
    from perfbench import run
    from perfbench.core.cell import Outcome, Readings

    cell = registry.cell("large_score_v8")
    out = Outcome({"videos_per_s": 36.5, "setup_s": 17.0}, 8, 0, {}, Readings(cell, {}),
                  str)
    line = run.result_line(_bench(), cell, out, False, {"platform": "gpu"})
    assert line["metrics"] == {"videos_per_s.large": {"value": 36.5, "unit": "videos/s"},
                               "setup_s": {"value": 17.0, "unit": "s"}}


def test_workload_init_overrides_the_configuration():
    """The training cell makes its weights with logit scale 1, the scoring
    cells of the same configuration with the configuration's 15."""
    assert registry.cell("tiny_train_vae_b32")["config"]["init"]["logit_scale"] == 1.0
    assert registry.cell("tiny_score_v8")["config"]["init"]["logit_scale"] == 15.0
    assert registry.load("configs", "genconvit_tiny")["init"]["logit_scale"] == 15.0


def _imports(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _sources(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_import_in_sources():
    for path in _sources(BENCH):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_names_compare_whole():
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    before = dict(sys.modules)
    try:
        sys.modules["genconvit_tpu_torch_x"] = sys
        assert "genconvit_tpu" not in run.forbidden_modules()
        sys.modules["genconvit_tpu.models"] = sys
        assert run.forbidden_modules() == ["genconvit_tpu"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(BENCH, "reference")
    for path in _sources(ref_dir):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & (FORBIDDEN | {"genconvit_tpu_torch"}), path
    code = ("import sys; sys.path.insert(0, %r); import perfbench.reference.model, "
            "perfbench.reference.train, perfbench.reference.init; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'genconvit_tpu_torch', 'genconvit_tpu', 'jax', 'jaxlib', 'flax'}))"
            % registry.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


NEW_CELL_SCRIPT = r"""
import json, sys, time
root, repo = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, repo]
import torch
from genconvit_tpu_torch.models import convnext
convnext.CONVNEXT_CFGS["convnext_bench_test"] = dict(depths=(1, 1, 2, 1), dims=(8, 16, 32, 64))
from perfbench import run
from perfbench.core import registry
assert registry.ROOT == root, registry.ROOT
bench = registry.benchmark()
cell = registry.cell("copy_score_small")
out = run.run_cell(cell, 2**31 + 7, 0.5, False, torch.device("cpu"), time.perf_counter())
line = run.result_line(bench, cell, out, False, {"platform": "cpu"})
line["forbidden"] = run.forbidden_modules()
print(json.dumps(line))
"""


def test_new_cell_runs_without_an_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a cell
    as files only (and their entries in BENCHMARK.json), and runs it."""
    from perfbench.tests.conftest import TEST_SIZES

    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _bench()
    cfg = registry.load("configs", "genconvit_tiny")
    cfg.update(TEST_SIZES, name="tiny_cpu")
    (root / "perfbench/configs/tiny_cpu.json").write_text(json.dumps(cfg))
    mix = registry.load("traffic", "score_v8")
    mix.update(pool_batches=2, videos_per_batch=2, batches_per_call=2, warmup_calls=1)
    (root / "perfbench/traffic/score_small.json").write_text(json.dumps(mix))
    wl = registry.load("workloads", "tiny_score_v8")
    wl.update(config="tiny_cpu", traffic="score_small", check_batches=2)
    (root / "perfbench/workloads/copy_score_small.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": "copy_score_small", "config": "tiny_cpu",
                               "traffic": "score_small", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "videos_per_s":
            m["workloads"].append("copy_score_small")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", NEW_CELL_SCRIPT, str(root), registry.ROOT],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"videos_per_s", "setup_s"}
    assert line["forbidden"] == []
    assert list(line)[-2] == "checks"    # the compared numbers come last


def test_without_the_port_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and perfbench/, the command
    exits non-zero and prints nothing on standard output."""
    root = tmp_path / "alone"
    shutil.copytree(BENCH, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "tiny_score_v8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["tiny_score_v8", "large_score_v8", "tiny_serve_poisson",
                                  "tiny_train_vae_b32"])
def test_cell_file_keys(cell):
    wl = registry.load("workloads", cell)
    assert set(wl) >= {"config", "traffic", "chips", "limits"} and wl["limits"]
    assert set(wl) <= {"config", "traffic", "chips", "limits", "init", "rate_per_s",
                       "check_batches", "check_requests"}
