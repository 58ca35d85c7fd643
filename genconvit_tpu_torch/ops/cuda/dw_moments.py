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

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. It counts its launches in `launches`.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def dw_moments_plain(x: torch.Tensor, k: torch.Tensor,
                     b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """M3's math in plain PyTorch: the taps as a product then a sum, each
    rounded (the kernel fuses them; with bf16-representable weights the
    product is exact and the two agree)."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 3, 3, 3, 3))
    acc = b.float().expand(n, h, w, c)
    k = k.float()
    for dy in range(7):
        for dx in range(7):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :].float() * k[dy, dx]
    inv_c = 1.0 / c
    mean = acc.sum(-1) * inv_c
    var = (acc * acc).sum(-1) * inv_c - mean * mean
    return acc.to(x.dtype), mean, var


def check_inputs(what: str, x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> None:
    """What the kernel takes: a contiguous 16-byte-aligned bf16 NHWC x with
    an even C, k [7, 7, C] and b [C] float32."""
    _require(x.dim() == 4, what, f"expected [N,H,W,C], got shape {tuple(x.shape)}")
    c = x.shape[-1]
    _require(x.dtype == torch.bfloat16, what, f"x must be bfloat16, got {x.dtype}")
    _require(c % 2 == 0, what, f"C={c} must be even")
    _require(x.is_contiguous(), what, "x must be contiguous (NHWC)")
    _require(x.data_ptr() % 16 == 0, what, "x must be 16-byte aligned")
    _check_vec(what, k, (7, 7, c), torch.float32, x.device)
    _check_vec(what, b, (c,), torch.float32, x.device)


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
