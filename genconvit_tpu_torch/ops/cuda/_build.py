"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes. No PyTorch headers are compiled, so
a build takes seconds. One nvcc per source, all started together, then
one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c genconvit_tpu_torch/csrc/<source>.cu -o <source>.o   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/genconvit_tpu_torch/libgcv_kernels_<hash>.so *.o

The hash covers the sources' and the headers' bytes and the flags, so an
edited source builds anew. The library is written under a temporary name and renamed into
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
SOURCES = tuple(os.path.join(_PKG_DIR, "csrc", f) for f in
                ("convnext_mlp.cu", "convnext_mlp_int8.cu", "convnext_mlp_int8_full.cu",
                 "int8_matmul.cu", "convnext_block.cu", "convnext_stage.cu",
                 "window_attn.cu", "layer_norm_rows.cu", "int8_dot.cu", "dw_moments.cu",
                 "block_parts.cu", "block_parts_hidden.cu", "block_parts_full.cu"))
HEADERS = tuple(os.path.join(_PKG_DIR, "csrc", f) for f in
                ("common.cuh", "wgmma.cuh", "mlp_wgmma.cuh", "convnext_mlp_int8.cuh",
                 "block_wgmma.cuh"))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "genconvit_tpu_torch")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # d, x, w1t, bw, w2t, b2g, lns, lnb, vbuf, out, rows, c, hp, stream
    "gcv_ln_mlp_residual": ([_P] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, _P], ctypes.c_int),
    # x, scale, bias, out, rows, c, stream
    "gcv_layer_norm_rows": ([_P] * 4 + [ctypes.c_longlong, ctypes.c_int, _P],
                            ctypes.c_int),
    # d, x, wq1, s1, bw, w2t, wq2k, s2, b2g, lns, lnb, vbuf, out, rows, c, hp, mode, stream
    "gcv_ln_mlp_residual_int8": ([_P] * 13 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int, _P],
                                 ctypes.c_int),
    # x, wq, scale, bias, xp, work, out, m, k, n, x_f32, out_f32, stream
    "gcv_matmul_wint8": ([_P] * 7 + [ctypes.c_int] * 5 + [_P], ctypes.c_int),
    # x, wdw, bdw, lns, lnb, w1t, b1, w2t, b2, gamma, out, n, h, w, c, stream
    "gcv_fused_block": ([_P] * 11 + [ctypes.c_int] * 4 + [_P], ctypes.c_int),
    # x, wdw, bdw, lns, lnb, w1t, b1, w2t, b2, gamma, ws, out, n, h, w, c, nb, stream
    "gcv_fused_stage": ([_P] * 12 + [ctypes.c_int] * 5 + [_P], ctypes.c_int),
    # qkv, bias, mask, out, windows, l, heads, hd, nw, scale, stream
    "gcv_window_attention": ([_P] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                             + [ctypes.c_float, _P], ctypes.c_int),
    # M1: y, h, w1, w2, out, rows, c, hid, stream
    "gcv_dots_bf16": ([_P] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [_P], ctypes.c_int),
    # M1: yq, hq, w1q, s1, w2q, s2, out, rows, c, hid, stream
    "gcv_dots_int8": ([_P] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [_P], ctypes.c_int),
    # M3: x, k, b, dw, mu, var, n, h, w, c, stream
    "gcv_dw_moments": ([_P] * 6 + [ctypes.c_int] * 4 + [_P], ctypes.c_int),
    # M2: x, wdw, bdw, lns, lnb, w1t, b1, w2t, b2, gamma, out, n, h, w, c, phase, stream
    "gcv_block_parts": ([_P] * 11 + [ctypes.c_int] * 5 + [_P], ctypes.c_int),
    "gcv_wint8_splits": ([ctypes.c_int] * 3, ctypes.c_int),
    "gcv_wint8_x_rows": ([ctypes.c_int], ctypes.c_int),
    "gcv_mlp_plan": ([ctypes.c_int, _P], ctypes.c_int),
    "gcv_k4_plan": ([ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
    "gcv_k5_plan": ([ctypes.c_int, _P], ctypes.c_int),
    # M1: c, hid, out
    "gcv_m1_plan": ([ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
    "gcv_k2_plan": ([ctypes.c_int, _P], ctypes.c_int),
    # M3: h, w, c, out
    "gcv_m3_plan": ([ctypes.c_int] * 3 + [_P], ctypes.c_int),
    # l, heads, hd, masked, windows, sms, out
    "gcv_k7_plan": ([ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int, _P], ctypes.c_int),
    # c, n, hw, sms, out
    "gcv_k6_plan": ([ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P],
                    ctypes.c_int),
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
    for src in SOURCES + HEADERS:
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
    nvcc = nvcc_path()
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(SOURCES, objs)]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    failed = [src for src, p in zip(SOURCES, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True, check=False)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    seconds = time.perf_counter() - t0
    for f in objs + ([tmp] if failed else []):
        if os.path.exists(f):
            os.remove(f)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
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
