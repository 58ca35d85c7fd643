"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes. No PyTorch headers are compiled, so
a build takes seconds.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/genconvit_tpu_torch/libgcv_kernels_<hash>.so
         genconvit_tpu_torch/csrc/convnext_mlp.cu

The hash covers the source bytes and the flags, so an edited source builds
anew. The library is written under a temporary name and renamed into
place, so processes that build at once never load a partial file. Nothing
builds at import: the first kernel launch (or `build()`) does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCES = (os.path.join(_PKG_DIR, "csrc", "convnext_mlp.cu"),)
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "genconvit_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # d, x, wg, bw, w2g, b2g, lns, lnb, out, rows, c, hp, stream
    "gcv_ln_mlp_residual": ([_P] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, _P], ctypes.c_int),
    # x, scale, bias, out, rows, c, stream
    "gcv_layer_norm_rows": ([_P] * 4 + [ctypes.c_longlong, ctypes.c_int, _P],
                            ctypes.c_int),
    "gcv_mlp_row_tile": ([ctypes.c_int], ctypes.c_int),
    "gcv_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register and spill report)


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def library_path() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgcv_kernels_{h.hexdigest()[:16]}.so")


def build() -> BuildInfo:
    """Compile the kernels unless this source and flag set is built."""
    path = library_path()
    log_path = path[:-3] + ".log"
    if os.path.isfile(path):
        log = ""
        if os.path.isfile(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildInfo(path, 0.0, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return BuildInfo(path, seconds, log)


_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every
    entry point's argtypes and restype declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build().path)
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _lib = lib
    return _lib


def is_loaded() -> bool:
    return _lib is not None


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = load().gcv_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
