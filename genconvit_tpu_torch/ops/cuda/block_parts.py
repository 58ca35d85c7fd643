"""M2: K5's fused ConvNeXt block (csrc/block_wgmma.cuh) cut after one of
its phases, as a hand-written CUDA probe kernel (csrc/block_parts.cu, with
its MLP cuts in block_parts_hidden.cu and block_parts_full.cu), with its
plain PyTorch version.

  block_parts  replaces `kern` (built by build()) of tools/microbench_kernel_parts.py

The phases, each writing [N, H, W, C] bf16 (microbench_kernel_parts.py:62-99):

  dma         x's rows copied as the taps read them
  dw          bf16(acc), acc = b_dw + the 49 taps, f32 sums (K5's)
  dw_bf16acc  the bias and every product and sum rounded to bf16 (the
              tool's fp32dw=False), no fused multiply-add
  ln          bf16 of the one-pass LayerNorm with its affine (eps 1e-6)
  fc1         the first C columns of bf16(y . w1 + b1), all 4C computed
  gelu        the first C columns of bf16(GELU(y . w1 + b1))
  full        the block output bf16(x + (h . w2 + b2) * gamma)

Every phase runs K5's schedule and plan (`m2_plan` = `convnext_block.k5_plan`)
up to its cut, so the per-phase time deltas attribute K5's time to its
steps; C up to K1_MAX_C = 1536. The GELU is the tool's
(convnext_stage._gelu_f32: e = zc * P * (1 / Q), hp coefficients), K6's
form, not K5's zc * (P / Q). The weights are K5's pack
(`convnext_block.FusedBlockWeights`, the kernel reads w1t and w2t): the
depthwise weights are bf16, where the tool's are f32. It is a tool
(genconvit_tpu_torch/tools/microbench_kernel_parts.py); no model path runs it.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. It counts its launches in `launches`.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda.convnext_block import (FusedBlockWeights, block_plain,
                                                         check_activation, check_weights,
                                                         k5_plan, kernel_operands)
from genconvit_tpu_torch.ops.cuda.convnext_block import planted_faults as k5_faults
from genconvit_tpu_torch.ops.cuda.convnext_mlp import _require, _stream, bf16_ulp_error
from genconvit_tpu_torch.ops.cuda.convnext_stage import _GELU

PHASES = ("dma", "dw", "dw_bf16acc", "ln", "fc1", "gelu", "full")   # = BlockStop's order
ULP_TOL = 2.0  # kernel vs plain, elementwise, in bf16 ulps (ulp_error), as K5
m2_plan = k5_plan   # M2 runs K5's plan at every width: None where it takes no c


def dw_bf16acc_plain(x: torch.Tensor, p: FusedBlockWeights) -> torch.Tensor:
    """The depthwise conv with bf16 sums: the bias, each product and each
    sum rounded to bf16 (torch rounds every bf16 op), taps in (dy, dx)
    order."""
    n, h, w, c = x.shape
    bf = torch.bfloat16
    xp = F.pad(x.to(bf), (0, 0, 3, 3, 3, 3))
    acc = p.b_dw.to(bf).expand(n, h, w, c)
    for dy in range(7):
        for dx in range(7):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :] * p.w_dw[dy * 7 + dx].to(bf)
    return acc


def block_parts_plain(x: torch.Tensor, p: FusedBlockWeights, phase: str) -> torch.Tensor:
    """M2's math in plain PyTorch: K5's block (convnext_block.block_plain)
    with the tool's GELU, cut after `phase`."""
    if phase == "dma":
        return x.clone()
    if phase == "dw_bf16acc":
        return dw_bf16acc_plain(x, p)
    return block_plain(x, p, _GELU, phase)


def block_parts(x: torch.Tensor, p: FusedBlockWeights, phase: str) -> torch.Tensor:
    """M2: the block on x [N,H,W,C] cut after `phase`; returns [N,H,W,C]."""
    what = "block_parts"
    _require(phase in PHASES, what, f"phase must be one of {PHASES}, got {phase!r}")
    if x.device.type == "cpu":
        return block_parts_plain(x, p, phase)
    _require(x.is_cuda, what, f"unsupported device {x.device}")
    check_activation(what, x)
    n, h, w, c = x.shape
    check_weights(what, p, c, x.device)
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.gcv_block_parts(x.data_ptr(), *(t.data_ptr() for t in kernel_operands(p)),
                                  out.data_ptr(), n, h, w, c, PHASES.index(phase),
                                  _stream(x.device))
    _build.check(err, what)
    block_parts.launches += 1
    return out


block_parts.launches = 0


def ulp_floor(ref: torch.Tensor, x: torch.Tensor, phase: str) -> tuple:
    """(x, scale) of convnext_mlp.bf16_ulp_error for `phase`. 'full' is held
    as K5 is (the ulp of max(|ref|, |x|), floored at the largest change the
    block made). 'fc1' and 'gelu' are computed from the rounded LN output
    y, whose elements the two versions may round one ulp apart (their LN
    statistics are summed in other orders); such a flip of y_k moves every
    hidden value of the row by w1[k, j] times an ulp of y_k, a small
    fraction of an ulp of the largest hidden value, so the floor is the ulp
    of max|ref|, as K1's is for its hidden. The other phases are held at
    each element's ulp, floored at max|ref| / 128: a copy, the depthwise
    sums (the same exact products in the same order) and y itself."""
    if phase == "full":
        return x, (ref.float() - x.float()).abs().max().item()
    if phase in ("fc1", "gelu"):
        return None, ref.float().abs().max().item()
    return None, None


def ulp_error(out: torch.Tensor, ref: torch.Tensor, x: torch.Tensor, phase: str) -> float:
    """max |out - ref| in bf16 ulps, floored as `ulp_floor` says."""
    return bf16_ulp_error(out, ref, *ulp_floor(ref, x, phase))


def planted_faults(p: FusedBlockWeights, phase: str) -> Dict[str, FusedBlockWeights]:
    """K5's planted faults (convnext_block.planted_faults) that change the
    output of `phase`: from 'dw' on, the depthwise bias dropped and the
    depthwise kernel transposed; from 'ln' on, the LN bias dropped."""
    if phase == "dma":
        return {}
    names = ["dw bias dropped", "dw kernel transposed"]
    if phase not in ("dw", "dw_bf16acc"):
        names.append("LN bias dropped")
    faults = k5_faults(p)
    return {name: faults[name] for name in names}
