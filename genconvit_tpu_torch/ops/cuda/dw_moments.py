"""M3: a depthwise 7x7 convolution with its per-pixel moments as a
hand-written CUDA probe kernel (csrc/dw_moments.cu), with its plain PyTorch
version.

  dw_moments  replaces `kernel` (entry shift7_fn) of tools/microbench_dwshift.py

Per pixel of an NHWC bf16 activation x [N, H, W, C], with f32 weights
k [7, 7, C] and bias b [C] (microbench_dwshift.py:93-103):

  acc  = b + sum over (dy, dx) of x[., y+dy-3, x+dx-3, .] * k[dy, dx]
         float32 from the bias, taps in (dy, dx) order, zero padding 3
  dw   = bf16(acc)                                           [N, H, W, C]
  mean = sum_c(acc) / C, var = sum_c(acc^2) / C - mean^2     [N, H, W] f32

The moments are those of the f32 sum before its rounding, as the Pallas
kernel takes them. The tool's xla_fn and the port's Block.forward_folded
(the LN-folded block, whose first half this is) take them from the rounded
dw instead: `dw_moments_library` computes that yardstick, cuDNN's depthwise
conv and the two reductions, and `moments_rounding_gap` the size of the
difference. It is a tool (genconvit_tpu_torch/tools/microbench_dwshift.py);
no model path runs it.

The kernel takes every even C and any H, W; `m3_plan` mirrors its plan
(work items of whole images or bands of rows, slices of g groups of 32
channels, runs of 7 columns, the ring's stages and shared memory,
csrc/dw_moments.cu m3_plan), `library_m3_plan` asks the built library. On a
CPU tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises. It counts its launches in `launches`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from genconvit_tpu_torch.ops.conv import conv2d
from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda.convnext_mlp import (_check_vec, _require, bf16_ulp_error,
                                                       _stream)

ULP_TOL = 2.0       # dw vs plain, elementwise, in bf16 ulps (the same f32 sums)
# mean and var vs plain, f32: the sums over C run in other orders, so each
# differs by float32 noise of the sum of |terms|: at most ~(log2 C + C/64)
# roundings of 2^-24, under 2e-6 of mean|acc| (mean) and of mean(acc^2)
# (var, whose - mean^2 adds 2|mean| times the mean's error). The bound is
# 1e-5 of those scales; a missing - mean^2 term alone is ~1/C of mean(acc^2).
MOMENT_TOL = 1e-5

RUN = 7                 # output columns of a task
_WARPS = 16             # a block's warps, all of them compute
_MAX_GROUPS = 8         # groups of 32 channels a slice: a TMA box of 256
_BAND_COLS = 8 * RUN    # columns of a work item at most
_SMEM_MAX = 232448
_SMEM_FIXED = 1024 + _WARPS * RUN * 36 * 4   # mbarriers, alignment, the warps' scratch
_MAX_STAGES = 4


class M3Plan(NamedTuple):
    """M3's plan at (h, w, c) (csrc/dw_moments.cu m3_plan)."""
    bh: int       # rows of a work item (the whole image, or a band)
    bw: int       # columns of a work item (the whole row, or 56)
    th: int       # output rows of a task (at most 7)
    nt: int       # tasks down an item: row tiles of th rows
    nr: int       # tasks across an item: runs of RUN columns
    g: int        # groups of 32 channels a slice
    tr: int       # tile rows of a slice: bh, plus a 3-row halo each side for a band
    tc: int       # tile columns: bw, plus a 3-column halo for a band of columns
    stages: int   # ring stages
    smem: int     # dynamic shared memory bytes
    tma: int      # 1: the stage by TMA (C % 8 == 0), 0: by the threads' copies


def _stage_bytes(tr: int, tc: int, g: int) -> int:
    """A ring stage: the x tile [tr][tc][32 g] bf16 (128-byte rounded), then
    the slice's weights [49][32 g] and bias [32 g] f32."""
    return (tr * tc * 64 * g + 127) // 128 * 128 + 50 * 128 * g


def _tasks(bh: int, nr: int, ng: int) -> Tuple[int, int, int]:
    """(th, nt, g) for an item of bh rows: as many row tiles of at most 7
    rows as make 16 tasks a slice, then the groups that fill the warps,
    spread evenly over the fewest slices."""
    cap = min(ng, _MAX_GROUPS)
    nt = -(-bh // 7)
    while nt < bh and nr * nt * cap < _WARPS:
        nt += 1
    th = -(-bh // nt)
    nt = -(-bh // th)
    g = min(max(_WARPS // (nr * nt), 1), cap)
    slices = -(-ng // g)
    return th, nt, -(-ng // slices)


def m3_plan(h: int, w: int, c: int) -> Optional[M3Plan]:
    """M3's plan, as the CUDA source computes it; None where the kernel does
    not take the shape (c odd, or a size not positive). The item is the
    whole image where two stages fit, else equal bands of rows (a multiple
    of 7 rows where that fits)."""
    if h <= 0 or w <= 0 or c <= 0 or c % 2:
        return None
    ng = -(-c // 32)
    bw = min(w, _BAND_COLS)
    tc = bw + (6 if bw < w else 0)
    nr = -(-bw // RUN)

    def smem(bh, tr, g, stages):
        return _SMEM_FIXED + 16 * g * bh * bw + stages * _stage_bytes(tr, tc, g)
    bh = tr = h
    th, nt, g = _tasks(h, nr, ng)
    if h > 250 or smem(h, h, g, 2) > _SMEM_MAX:
        for bh in range(min(h - 1, 250), 0, -1):
            if bh > 7 and bh % 7:
                continue
            th, nt, g = _tasks(bh, nr, ng)
            if smem(bh, bh + 6, g, 2) <= _SMEM_MAX:
                break
        else:
            return None
        fit = bh
        bands = -(-h // bh)
        bh = -(-h // bands)
        th, nt, g = _tasks(bh, nr, ng)
        if smem(bh, bh + 6, g, 2) > _SMEM_MAX:   # the equal bands take more groups
            bh = fit
            th, nt, g = _tasks(bh, nr, ng)
        tr = bh + 6
    stages = min(_MAX_STAGES, (_SMEM_MAX - smem(bh, tr, g, 0)) // _stage_bytes(tr, tc, g))
    return M3Plan(bh, bw, th, nt, nr, g, tr, tc, stages, smem(bh, tr, g, stages),
                  int(c % 8 == 0))


def library_m3_plan(h: int, w: int, c: int) -> Optional[M3Plan]:
    """M3's plan as the built library computes it (loads the library); the
    card tests hold `m3_plan` against it."""
    out = (ctypes.c_int * 11)()
    return M3Plan(*out) if _build.load().gcv_m3_plan(h, w, c, out) else None


def _taps(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 sums acc of M3, from the bias, taps in (dy, dx) order."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 3, 3, 3, 3))
    acc = b.float().expand(n, h, w, c)
    k = k.float()
    for dy in range(7):
        for dx in range(7):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :].float() * k[dy, dx]
    return acc


def dw_moments_plain(x: torch.Tensor, k: torch.Tensor,
                     b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """M3's math in plain PyTorch: the taps as a product then a sum, each
    rounded (the kernel fuses them; with bf16-representable weights the
    product is exact and the two agree)."""
    c = x.shape[-1]
    acc = _taps(x, k, b)
    inv_c = 1.0 / c
    mean = acc.sum(-1) * inv_c
    var = (acc * acc).sum(-1) * inv_c - mean * mean
    return acc.to(x.dtype), mean, var


def check_inputs(what: str, x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> None:
    """What the kernel takes: a contiguous 16-byte-aligned bf16 NHWC x with
    an even C, k [7, 7, C] and b [C] float32. The messages are formatted
    only for an input that fails (formatting a shape costs more host time
    than a small launch takes on the card)."""
    if x.dim() != 4:
        _require(False, what, f"expected [N,H,W,C], got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if x.dtype != torch.bfloat16:
        _require(False, what, f"x must be bfloat16, got {x.dtype}")
    if c % 2:
        _require(False, what, f"C={c} must be even")
    _require(x.is_contiguous(), what, "x must be contiguous (NHWC)")
    _require(x.data_ptr() % 16 == 0, what, "x must be 16-byte aligned")
    for t, shape in ((k, (7, 7, c)), (b, (c,))):
        if (t.device != x.device or t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous() or t.data_ptr() % 32):
            _check_vec(what, t, shape, torch.float32, x.device)


def dw_moments(x: torch.Tensor, k: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """M3: (dw [N,H,W,C] bf16, mean [N,H,W] f32, var [N,H,W] f32) of x."""
    if x.device.type == "cpu":
        return dw_moments_plain(x, k, b)
    what = "dw_moments"
    _require(x.is_cuda, what, f"unsupported device {x.device}")
    check_inputs(what, x, k, b)
    n, h, w, c = x.shape
    dw = torch.empty_like(x)
    mean = torch.empty(n, h, w, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.gcv_dw_moments(x.data_ptr(), k.data_ptr(), b.data_ptr(), dw.data_ptr(),
                                 mean.data_ptr(), var.data_ptr(), n, h, w, c, _stream(x.device))
    _build.check(err, what)
    dw_moments.launches += 1
    return dw, mean, var


dw_moments.launches = 0


def moment_scales(acc_dw: torch.Tensor) -> Tuple[float, float]:
    """(mean |dw|, mean dw^2) over the whole tensor, the scales of
    MOMENT_TOL (from the rounded dw: within 2^-8 of the f32 sums')."""
    d = acc_dw.float()
    return d.abs().mean().item(), (d * d).mean().item()


def ulp_error(out, ref) -> Dict[str, float]:
    """How far the kernel's (dw, mean, var) sit from the plain version's:
    dw in bf16 ulps (convnext_mlp.bf16_ulp_error), mean and var as max
    |diff| relative to moment_scales of the plain dw. Within ULP_TOL and
    MOMENT_TOL they agree."""
    mu_scale, sq_scale = moment_scales(ref[0])
    return {"dw_ulps": bf16_ulp_error(out[0], ref[0]),
            "mean_rel": (out[1] - ref[1]).abs().max().item() / mu_scale,
            "var_rel": (out[2] - ref[2]).abs().max().item() / sq_scale}


def agrees(err: Dict[str, float]) -> bool:
    return (err["dw_ulps"] <= ULP_TOL and err["mean_rel"] <= MOMENT_TOL
            and err["var_rel"] <= MOMENT_TOL)


def dw_moments_library(x: torch.Tensor, k: torch.Tensor,
                       b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The yardstick, as Block.forward_folded computes the same quantities:
    the depthwise conv (cuDNN on the card, bf16 weights) on the NCHW view,
    then the f32 moments of the rounded dw with two eager reductions. The
    port never calls it."""
    c = x.shape[-1]
    wt = k.permute(2, 0, 1).reshape(c, 1, 7, 7).to(x.dtype)
    d = conv2d(x.permute(0, 3, 1, 2), wt, b.to(x.dtype), padding=3, groups=c)
    d = d.permute(0, 2, 3, 1)
    d32 = d.float()
    mean = d32.mean(-1)
    return d, mean, (d32 * d32).mean(-1) - mean * mean


def moments_rounding_gap(dw: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor) -> Tuple[float, float]:
    """How far the moments of the rounded dw sit from the f32 sums' moments
    (the kernel's), relative to moment_scales: the difference between the
    kernel's and the yardstick's definition, which neither gets wrong."""
    d32 = dw.float()
    m2 = d32.mean(-1)
    v2 = (d32 * d32).mean(-1) - m2 * m2
    mu_scale, sq_scale = moment_scales(dw)
    return ((m2 - mean).abs().max().item() / mu_scale,
            (v2 - var).abs().max().item() / sq_scale)


def planted_faults(k: torch.Tensor, b: torch.Tensor) -> Dict[str, tuple]:
    """(k, b) each with one term of M3's depthwise math wrong, as a kernel
    that forgot it would read them: the bias dropped, the kernel transposed
    (dy and dx swapped). The third fault, var without its - mean^2 term, is
    an output fault: `var_without_mean_sq`."""
    return {"bias dropped": (k, torch.zeros_like(b)),
            "kernel transposed": (k.transpose(0, 1).contiguous(), b)}


def var_without_mean_sq(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """What a kernel that forgot the - mean^2 term would return as var."""
    return var + mean * mean


def halo_from_neighbour(x: torch.Tensor) -> torch.Tensor:
    """x as a kernel would read it whose halo rows came from the image
    before (a map over [N H, W, C] in place of [N, H, W, C]): the rows
    within 3 of the top and bottom edges taken from that image. Its fault
    shows only near the edges, and only where the images differ."""
    bad = x.clone()
    rolled = x.roll(1, 0)
    bad[:, :3] = rolled[:, :3]
    bad[:, -3:] = rolled[:, -3:]
    return bad


def moments_without_last_slice(x: torch.Tensor, k: torch.Tensor,
                               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version's outputs as a kernel would give them that left the
    last slice of m3_plan's channels (the ragged one, where C is not a
    multiple of the slice) out of the moments: dw right, mean and var
    summed over the other channels (over all of them when there is one
    slice: then the sums are 0)."""
    _, h, w, c = x.shape
    gc = 32 * m3_plan(h, w, c).g
    acc = _taps(x, k, b)
    a = acc * (torch.arange(c, device=x.device) < (-(-c // gc) - 1) * gc).to(acc.dtype)
    inv_c = 1.0 / c
    mean = a.sum(-1) * inv_c
    return acc.to(x.dtype), mean, (a * a).sum(-1) * inv_c - mean * mean
