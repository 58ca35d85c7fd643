"""M1: the two matrix products of a ConvNeXt block tail, in bf16 and in
int8, as hand-written CUDA probe kernels (csrc/int8_dot.cu), with their
plain PyTorch versions.

  dots_bf16  replaces dots_bf16_kernel of tools/microbench_int8_dot.py
  dots_int8  replaces dots_int8_kernel of the same tool

Per row of [rows, c] (microbench_int8_dot.py:51-66):

  bf16   out = bf16(o + z[:, :c]),  z = y . w1^T, o = h . w2^T    f32 sums
  int8   out = bf16(f32(o) * s2 + f32(z[:, :c]) * s1[:c])         int32 sums

with y [rows, c], h [rows, hid], and the weights in the torch Linear layout:
w1 [hid, c] and w2 [c, hid] (the JAX tool's w1 [c, hid] and w2 [hid, c]
transposed). All hid columns of z are computed, though only the first c
reach the output: the probe times K4's two products (fc1 [R, C] x [C, 4C],
fc2 [R, 4C] x [4C, C]) without K4's quantization passes. It is a tool
(genconvit_tpu_torch/tools/microbench_int8_dot.py); no model path runs it.

The kernels take c a multiple of 32 up to K1_MAX_C = 1536 and hid a
multiple of 32 in [c, 4c]; `m1_plan` mirrors their plan (work items of 128
rows and one group of `cols` output columns, the ring's stages and shared
memory, csrc/int8_dot.cu dot_plan), `library_m1_plan` asks the built
library. On a CPU tensor a wrapper runs the plain version; on a CUDA tensor
it launches the kernel or raises. Each counts its launches in `launches`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda.convnext_mlp import (K1_MAX_C, _SMEM_MAX, _check_vec,
                                                       _require, bf16_ulp_error, _stream)
from genconvit_tpu_torch.ops.cuda.convnext_mlp_int8 import _int_dot

ULP_TOL = 2.0       # bf16 variant vs plain, elementwise, in bf16 ulps: one rounding
ULP_TOL_INT8 = 1.0  # int8 variant: exact integer sums, the same f32 epilogue


class M1Plan(NamedTuple):
    """M1's plan at (c, hid) (csrc/int8_dot.cu dot_plan)."""
    rows: int     # rows of a work item: 64 for each of two consumer warpgroups
    cols: int     # output columns of a work item (and z's column blocks)
    stages: int   # ring stages: an A tile of y or h and a B tile of w1 or w2 each
    smem: int     # dynamic shared memory bytes


def m1_plan(c: int, hid: int) -> Optional[M1Plan]:
    """M1's plan, as the CUDA source computes it; None where the kernels do
    not take (c, hid): c a multiple of 32 in [32, K1_MAX_C], hid a multiple
    of 32 in [c, 4c]. The group width is the one of 64 and 128 that computes
    the fewest columns of o and of z (all hid columns), 128 on a tie."""
    if c < 32 or c > K1_MAX_C or c % 32 or hid % 32 or not c <= hid <= 4 * c:
        return None

    def cost(nc):
        return (-(-c // nc) - (-hid // nc)) * nc
    nc = 64 if cost(64) < cost(128) else 128
    stage = 16384 + nc * 128
    stages = min(8, (_SMEM_MAX - 1024 - 256) // stage)
    return M1Plan(128, nc, stages, 1024 + stages * stage + 256)


def library_m1_plan(c: int, hid: int) -> Optional[M1Plan]:
    """M1's plan as the built library computes it (loads the library); the
    card tests hold `m1_plan` against it."""
    out = (ctypes.c_int * 4)()
    return M1Plan(*out) if _build.load().gcv_m1_plan(c, hid, out) else None


def dots_bf16_plain(y: torch.Tensor, h: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """M1's bf16 math: two f32 products of the bf16 operands (exact
    products, f32 sums), then one rounding of o + z[:, :c]."""
    c = y.shape[-1]
    z = y.float() @ w1.float().t()
    o = h.float() @ w2.float().t()
    return (o + z[:, :c]).to(torch.bfloat16)


def dots_int8_plain(yq: torch.Tensor, hq: torch.Tensor, w1q: torch.Tensor, s1: torch.Tensor,
                    w2q: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """M1's int8 math: exact integer sums (K4's, in float64), each rounded
    once to float32 as the kernel's int32 -> float32 conversion rounds it,
    then the scales in f32."""
    c = yq.shape[-1]
    zf = _int_dot(yq, w1q) * s1.float()
    of = _int_dot(hq, w2q) * s2.float()
    return (of + zf[:, :c]).to(torch.bfloat16)


def _check(what: str, acts, weights, dtype: torch.dtype) -> Tuple[int, int, int]:
    """What the kernels take: contiguous 16-byte-aligned rows y [rows, c],
    h [rows, hid] and weights w1 [hid, c], w2 [c, hid] of `dtype`, (c, hid)
    one `m1_plan` takes: c a multiple of 32 up to K1_MAX_C, hid a multiple of
    32 in [c, 4c]."""
    y, h = acts
    w1, w2 = weights
    _require(y.dim() == 2 and h.dim() == 2, what, "y and h must be [rows, c] and [rows, hid]")
    rows, c = y.shape
    hid = h.shape[1]
    _require(h.shape[0] == rows, what, f"h has {h.shape[0]} rows, y {rows}")
    _require(c % 32 == 0 and 0 < c <= K1_MAX_C, what,
             f"c={c} must be a multiple of 32 up to {K1_MAX_C}")
    _require(hid % 32 == 0 and c <= hid <= 4 * c, what,
             f"hid={hid} must be a multiple of 32 in [c, 4c] = [{c}, {4 * c}]")
    for t in (y, h):
        _require(t.device == y.device, what, "tensors on different devices")
        _require(t.dtype == dtype, what, f"expected {dtype}, got {t.dtype}")
        _require(t.is_contiguous(), what, "rows must be contiguous")
        _require(t.data_ptr() % 16 == 0, what, "rows must be 16-byte aligned")
    _check_vec(what, w1, (hid, c), dtype, y.device)
    _check_vec(what, w2, (c, hid), dtype, y.device)
    return rows, c, hid


def dots_bf16(y: torch.Tensor, h: torch.Tensor, w1: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """M1, bf16: out [rows, c] = bf16(h . w2^T + (y . w1^T)[:, :c])."""
    if y.device.type == "cpu":
        return dots_bf16_plain(y, h, w1, w2)
    what = "dots_bf16"
    _require(y.is_cuda, what, f"unsupported device {y.device}")
    rows, c, hid = _check(what, (y, h), (w1, w2), torch.bfloat16)
    out = torch.empty_like(y)
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.gcv_dots_bf16(y.data_ptr(), h.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                                out.data_ptr(), rows, c, hid, _stream(y.device))
    _build.check(err, what)
    dots_bf16.launches += 1
    return out


dots_bf16.launches = 0


def dots_int8(yq: torch.Tensor, hq: torch.Tensor, w1q: torch.Tensor, s1: torch.Tensor,
              w2q: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """M1, int8: out [rows, c] = bf16(f32(hq . w2q^T) * s2 + f32(yq . w1q^T)[:, :c] * s1[:c])."""
    if yq.device.type == "cpu":
        return dots_int8_plain(yq, hq, w1q, s1, w2q, s2)
    what = "dots_int8"
    _require(yq.is_cuda, what, f"unsupported device {yq.device}")
    rows, c, hid = _check(what, (yq, hq), (w1q, w2q), torch.int8)
    _check_vec(what, s1, (hid,), torch.float32, yq.device)
    _check_vec(what, s2, (c,), torch.float32, yq.device)
    out = torch.empty(rows, c, dtype=torch.bfloat16, device=yq.device)
    lib = _build.load()
    with torch.cuda.device(yq.device):
        err = lib.gcv_dots_int8(yq.data_ptr(), hq.data_ptr(), w1q.data_ptr(), s1.data_ptr(),
                                w2q.data_ptr(), s2.data_ptr(), out.data_ptr(), rows, c, hid,
                                _stream(yq.device))
    _build.check(err, what)
    dots_int8.launches += 1
    return out


dots_int8.launches = 0


def ulp_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| in bf16 ulps of each element, floored at the ulp of
    max|ref| / 128 (convnext_mlp.bf16_ulp_error): the two versions round
    the output once, at the same point."""
    return bf16_ulp_error(out, ref)


def planted_faults(kind: str, w1: torch.Tensor, s1: torch.Tensor,
                   w2: torch.Tensor) -> Dict[str, tuple]:
    """(w1, s1, w2) each with one term of M1's math wrong, as a kernel that
    forgot it would read them: z's add dropped (w1 = 0), s1 replaced by its
    mean (int8 only) and w2 read transposed (its [c, hid] storage taken as
    [hid, c]). The check of a kernel against its plain version must refuse
    every one."""
    c, hid = w2.shape
    faults = {"z's add dropped": (torch.zeros_like(w1), s1, w2),
              "w2 transposed": (w1, s1, w2.reshape(hid, c).t().contiguous())}
    if kind == "int8":
        faults["s1 by its mean"] = (w1, s1.mean().expand_as(s1).contiguous(), w2)
    return faults
