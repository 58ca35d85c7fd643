"""The port stands alone: importing every module of genconvit_tpu_torch
loads no JAX, flax, optax, yaml, msgpack or genconvit_tpu, no cv2, sklearn or
matplotlib (the host libraries stay lazy) and builds no kernel; its
sources carry no such import and no torch.compile; chip_smoke.py refuses
to run without CUDA before it builds anything."""

import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "genconvit_tpu_torch"

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import genconvit_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
from genconvit_tpu_torch.ops.cuda import _build
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "yaml", "msgpack",
                                    "genconvit_tpu",
                                    "triton", "cv2", "sklearn", "matplotlib"))
print(json.dumps({"modules": names, "bad": bad, "built": _build.is_loaded()}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_importing_every_module_loads_nothing_forbidden():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert "genconvit_tpu_torch.ops.cuda.convnext_mlp" in rec["modules"]
    assert "genconvit_tpu_torch.infer.engine" in rec["modules"]
    for name in ("models.swin", "models.hybrid_embed", "ops.cuda.window_attn",
                 "ops.cuda.int8_dot", "ops.cuda.block_parts", "ops.cuda.dw_moments",
                 "tools.microbench_int8_dot", "tools.microbench_kernel_parts",
                 "tools.microbench_dwshift", "core.checkpoint", "data.faces", "data.video",
                 "data.native", "data.frames", "models.facedet", "infer.walkers",
                 "infer.result", "utils.timing", "prediction", "device", "evalx.metrics",
                 "evalx.plots", "data.folder", "data.augment", "infer.batcher",
                 "infer.serve_pipeline", "serve", "prediction_v2", "evaluate", "result_all",
                 "plot_comparison", "train.optim", "train.loop", "train.facedet_train",
                 "train.__main__"):
        assert f"genconvit_tpu_torch.{name}" in rec["modules"]
    assert rec["bad"] == []
    assert rec["built"] is False


def test_sources_import_no_jax_and_compile_nothing():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|yaml|msgpack|genconvit_tpu)\b"
                         r"|torch\.compile", re.M)
    paths = list(PKG.rglob("*.py"))
    assert {"swin.py", "hybrid_embed.py", "window_attn.py", "int8_dot.py", "block_parts.py",
            "dw_moments.py", "microbench_int8_dot.py", "microbench_kernel_parts.py",
            "microbench_dwshift.py", "checkpoint.py", "faces.py", "facedet.py", "video.py",
            "native.py", "walkers.py", "result.py", "timing.py",
            "prediction.py", "metrics.py", "plots.py", "folder.py", "augment.py", "batcher.py",
            "serve_pipeline.py", "serve.py", "prediction_v2.py", "evaluate.py", "result_all.py",
            "plot_comparison.py", "optim.py", "loop.py", "facedet_train.py",
            "__main__.py"} <= {p.name for p in paths}
    for path in paths + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_chip_smoke_refuses_without_cuda():
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert time.monotonic() - t0 < 60
