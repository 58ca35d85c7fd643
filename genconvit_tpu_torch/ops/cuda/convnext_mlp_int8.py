"""K4: the ConvNeXt block tail with int8 matmuls as a hand-written CUDA
kernel (csrc/convnext_mlp_int8.cu, on K1's warpgroup-MMA loop in
csrc/mlp_wgmma.cuh), with its plain PyTorch version.

  ln_mlp_residual_int8  replaces fused_ln_mlp_residual(int8='fc1')
                        (_mlp_kernel_int8_fc1, _mlp_kernel_post_ln_int8_fc1)
                        and int8='full' (_mlp_kernel_int8,
                        _mlp_kernel_post_ln_int8) of
                        genconvit_tpu/ops/pallas/convnext_mlp.py

The two modes (KernelPlan.int8_mlp):
  'fc1'   y = LN(d) in f32, quantized with the fixed scale 127/8; fc1 int8
          x int8 -> int32; h = GELU in the weights' dtype; fc2 as K1's
  'full'  y and GELU(z) quantized per row (absmax / 127); both matmuls
          int8 x int8 -> int32
Weights quantize per output column from the float32 folds (never from
the rounded ones), once, at engine construction (`fold_block_mlp_int8`),
which also stores fc2's weights as the kernel reads them: w2g transposed
('fc1') or wq2 with k in kernel order ('full', `kernel_order`). The kernel
takes every multiple of 32 up to K4_MAX_C (its tile plan: `k4_plan`). On a
CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. It counts its launches in
`ln_mlp_residual_int8.launches`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from genconvit_tpu_torch.ops.act import gelu_rational_f32
from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda.convnext_mlp import (_check_rows, _check_vec,
                                                       _require, _row_moments,
                                                       _stream, fold_block_mlp_f32)
from genconvit_tpu_torch.ops.quant import (FIXED_ACT_CLIP, quant_cols,
                                           quant_fixed, quant_rows)

MODES = ("fc1", "full")
K4_MAX_C = 1536   # fc2's output columns split into groups (k4_plan)
# Kernel vs plain, elementwise, in bf16 ulps (convnext_mlp.bf16_ulp_error
# with K1's floors): K1's 2, plus 1 for one int8 step. The two take the LN
# statistics in other summation orders, so a y * scale (in 'full' also an
# h * scale) within float32 noise of a rounding midpoint quantizes one
# step apart. One step of y element k moves every z_n of its row by
# wq1[n, k] * s1[n] (times sa in 'full'), 1/127 of the clip range times
# the weight; through GELU and fc2 that is a sum of 4C terms of random
# sign, about sqrt(4C) * step * |w1| * |w2|, near a quarter of an ulp of
# max|o| at the scoring path's weights (one hq step is one term of the
# fc2 sum, smaller still). One more ulp covers a flip on top of K1's two
# rounding flips; the planted faults sit at 6.6 ulps and above.
ULP_TOL = 3.0


# K4's 'full' fc2 takes its A operand from fc1's s32 accumulator, where
# thread t of a quad holds hidden 2t, 2t+1, 8+2t, 9+2t, 16+2t, .. of each
# 32-block; a k32 A fragment holds k 4t..4t+3 and 16+4t..19+4t. Position p
# of a 32-block of wq2k holds hidden KERNEL_K_ORDER[p] of wq2 (the int32 sum
# is exact in any order).
KERNEL_K_ORDER = tuple(16 * (p // 16) + 8 * ((p % 4) // 2) + 2 * ((p % 16) // 4) + p % 2
                       for p in range(32))


def kernel_order(t: torch.Tensor) -> torch.Tensor:
    """t's last axis (a multiple of 32) in K4's kernel k order."""
    n = t.shape[-1]
    index = torch.tensor([32 * (k // 32) + KERNEL_K_ORDER[k % 32] for k in range(n)],
                         dtype=torch.long, device=t.device)
    return t.index_select(-1, index).contiguous()


class K4Plan(NamedTuple):
    """K4's tile plan at one width and mode (csrc/convnext_mlp_int8.cu
    k4_plan)."""
    rows: int     # rows per block: 128 (two warpgroups of 64) or 64 (shared)
    cols: int     # output columns per fc2 group
    kbs: int      # w1t tiles (64 hidden x 128 k) per fc1 stage
    stages: int   # weight ring stages
    smem: int     # dynamic shared memory bytes

    def passes(self, c: int) -> int:
        """Passes over the hidden dimension per row tile (fc1 once each;
        'full' runs one more, for the row maxima)."""
        groups = -(-c // self.cols)
        return groups if self.rows == 128 else -(-groups // 2)


# (rows, NC, KB) the kernel is built for, per mode, in the source's order
_K4_CANDIDATES = {
    "fc1": ((128, 192, 1), (128, 192, 2), (128, 128, 1), (128, 128, 2), (128, 96, 1),
            (64, 192, 2), (64, 128, 2)),
    "full": ((128, 192, 2), (128, 128, 1), (128, 96, 1), (64, 192, 2)),
}
_SMEM_MAX = 232448
_SMEM_MISC = 1152 + 512   # mbarriers, the post-LN's row sums, the row scales


def k4_plan(c: int, mode: str) -> Optional[K4Plan]:
    """K4's tile plan at width c, as the CUDA source computes it: among the
    built candidates whose ring holds a turn, the one with the fewest L2
    weight bytes (x 370) plus tensor operations (bf16 twice) per 128 rows;
    None where K4 does not take c (a multiple of 32 in [32, K4_MAX_C])."""
    if mode not in MODES:
        raise ValueError(f"int8 mode must be one of {MODES}, got {mode!r}")
    if c < 32 or c > K4_MAX_C or c % 32:
        return None
    full = mode == "full"
    nkb = -(-c // 128)
    best = None
    for rows, nc, kb in _K4_CANDIDATES[mode]:
        if kb > nkb:
            continue
        ybytes = rows * nkb * 128
        stage = max(kb * 8192, nc * 64 if full else nc * 128)
        stages = min(8, (_SMEM_MAX - 1024 - ybytes - _SMEM_MISC) // stage)
        if stages < -(-nkb // kb) + (1 if rows == 128 else 2):
            continue
        groups = -(-c // nc)
        passes = groups if rows == 128 else -(-groups // 2)
        tiles = 128 // rows
        runs = passes + int(full)
        wbytes = tiles * runs * 4 * c * c + tiles * 4 * c * groups * nc * (1 if full else 2)
        ops = runs * 2 * tiles * 64 * c * 4 * c * 2 + 128 * 4 * c * groups * nc * 2 * (1 if full else 2)
        cost = wbytes * 370 + ops
        if best is None or cost < best[0]:
            best = (cost, K4Plan(rows, nc, kb, stages,
                                 1024 + ybytes + stages * stage + _SMEM_MISC))
    return None if best is None else best[1]


def library_plan(c: int, mode: str) -> Optional[K4Plan]:
    """K4's tile plan as the built library computes it (loads the library);
    the card tests hold `k4_plan` against it."""
    out = (ctypes.c_int * 5)()
    return K4Plan(*out) if _build.load().gcv_k4_plan(c, MODES.index(mode) + 1, out) else None


class FoldedMLPInt8(NamedTuple):
    """A block's MLP folded and quantized for one int8 mode. The int8
    matrices keep the torch Linear layout [out, in]; fc2's weights are also
    kept as the kernel reads them (w2t, wq2k)."""
    mode: str                      # 'fc1' | 'full'
    wq1: torch.Tensor              # [4C, C] int8: quant_cols(ln_scale * W1)
    s1: torch.Tensor               # [4C] f32 ('fc1': times 8/127)
    bw: torch.Tensor               # [4C] f32: ln_bias @ W1 + b1
    w2g: Optional[torch.Tensor]    # 'fc1': [4C, C] compute dtype, W2 * gamma
    wq2: Optional[torch.Tensor]    # 'full': [C, 4C] int8: quant_cols(W2 * gamma)
    s2: Optional[torch.Tensor]     # 'full': [C] f32
    b2g: torch.Tensor              # [C] f32: b2 * gamma
    w2t: Optional[torch.Tensor] = None    # 'fc1': [C, 4C] w2g transposed, contiguous
    wq2k: Optional[torch.Tensor] = None   # 'full': [C, 4C] wq2 in kernel k order


def fold_block_mlp_int8(ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                        fc2_bias, gamma, mode: str, dtype: torch.dtype) -> FoldedMLPInt8:
    """The folds of convnext_mlp.py:388-397 in float32, quantized as
    :400-422 does; `dtype` is the compute dtype of 'fc1' mode's w2g."""
    if mode not in MODES:
        raise ValueError(f"int8 mode must be one of {MODES}, got {mode!r}")
    f = fold_block_mlp_f32(ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                           fc2_bias, gamma)
    wq1, s1 = quant_cols(f.wg)                  # [C, 4C], [4C]
    wq1 = wq1.t().contiguous()
    if mode == "fc1":
        s1 = s1 * torch.tensor(FIXED_ACT_CLIP / 127.0, dtype=torch.float32,
                               device=s1.device)
        w2g = f.w2g.to(dtype).contiguous()
        return FoldedMLPInt8(mode, wq1, s1.contiguous(), f.bw, w2g, None, None, f.b2g,
                             w2t=w2g.t().contiguous())
    wq2, s2 = quant_cols(f.w2g)                 # [4C, C], [C]
    wq2 = wq2.t().contiguous()
    return FoldedMLPInt8(mode, wq1, s1.contiguous(), f.bw, None, wq2, s2.contiguous(),
                         f.b2g, wq2k=kernel_order(wq2))


def _int_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 a [..., K] . int8 w [N, K]^T as float32: the product runs in
    float64, exact (|sum| <= 6144 * 127^2 < 2^31, the kernel's int32 sum),
    then rounds once to float32, as the kernel's int32 -> float32
    conversion does."""
    return (a.double() @ w.double().t()).float()


def ln_mlp_residual_int8_plain(dw: torch.Tensor, x: torch.Tensor, folded: FoldedMLPInt8,
                               post_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                               gelu: str = "default",
                               kernel_k_order: bool = False) -> torch.Tensor:
    """K4's math in plain PyTorch, with the kernel's rounding points.
    kernel_k_order: 'full' mode's fc2 through wq2k and hq in kernel order,
    as the kernel sums it (the same exact int32 sum)."""
    dtype = x.dtype
    d32 = dw.float()
    mean, inv = _row_moments(d32)
    y = (d32 - mean) * inv
    if folded.mode == "fc1":
        z = _int_dot(quant_fixed(y), folded.wq1)
        h = gelu_rational_f32(z * folded.s1 + folded.bw, gelu).to(folded.w2g.dtype)
        o = h.float() @ folded.w2g.float() + folded.b2g
    else:
        yq, sa = quant_rows(y)
        z = _int_dot(yq, folded.wq1)
        h = gelu_rational_f32(z * sa * folded.s1 + folded.bw, gelu)
        hq, sb = quant_rows(h)
        if kernel_k_order:
            o = _int_dot(kernel_order(hq), folded.wq2k)
        else:
            o = _int_dot(hq, folded.wq2)
        o = o * sb * folded.s2 + folded.b2g
    if post_ln is None:
        return x + o.to(dtype)
    out = x.float() + o
    m2, inv2 = _row_moments(out)
    return ((out - m2) * inv2 * post_ln[0].float() + post_ln[1].float()).to(dtype)


def ln_mlp_residual_int8(dw: torch.Tensor, x: torch.Tensor, folded: FoldedMLPInt8,
                         post_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         gelu: str = "default") -> torch.Tensor:
    """K4: block tail with int8 matmuls, in folded.mode. dw = depthwise-conv
    output and x = block input, both [..., C]; returns the block output
    (or, with post_ln=(scale, bias), its LayerNorm with those f32 params)."""
    what = "ln_mlp_residual_int8"
    _require(folded.mode in MODES, what, f"unknown int8 mode {folded.mode!r}")
    if dw.device.type == "cpu" and x.device.type == "cpu":
        return ln_mlp_residual_int8_plain(dw, x, folded, post_ln, gelu)
    _require(dw.is_cuda, what, f"unsupported device {dw.device}")
    _check_rows(what, dw, x)
    c = x.shape[-1]
    plan = k4_plan(c, folded.mode)
    _require(plan is not None, what, f"C={c} exceeds {K4_MAX_C}")
    _require(gelu in ("default", "hp"), what, f"no kernel GELU tier {gelu!r}")
    dev = x.device
    f32 = torch.float32
    _check_vec(what, folded.wq1, (4 * c, c), torch.int8, dev)
    _check_vec(what, folded.s1, (4 * c,), f32, dev)
    _check_vec(what, folded.bw, (4 * c,), f32, dev)
    _check_vec(what, folded.b2g, (c,), f32, dev)
    if folded.mode == "fc1":
        _require(folded.w2t is not None, what,
                 "the folds lack w2t (make them with fold_block_mlp_int8)")
        _check_vec(what, folded.w2t, (c, 4 * c), torch.bfloat16, dev)
    else:
        _require(folded.wq2k is not None, what,
                 "the folds lack wq2k (make them with fold_block_mlp_int8)")
        _check_vec(what, folded.wq2k, (c, 4 * c), torch.int8, dev)
        _check_vec(what, folded.s2, (c,), f32, dev)
    lns = lnb = None
    if post_ln is not None:
        lns, lnb = post_ln
        _check_vec(what, lns, (c,), f32, dev)
        _check_vec(what, lnb, (c,), f32, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    out = torch.empty_like(x)
    rows = x.numel() // c
    # post-LN over more than one pass keeps x + o in float32 here
    vbuf = (torch.empty((rows, c), dtype=f32, device=dev)
            if post_ln is not None and plan.passes(c) > 1 else None)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.gcv_ln_mlp_residual_int8(
            dw.data_ptr(), x.data_ptr(), folded.wq1.data_ptr(), folded.s1.data_ptr(),
            folded.bw.data_ptr(), ptr(folded.w2t), ptr(folded.wq2k), ptr(folded.s2),
            folded.b2g.data_ptr(), ptr(lns), ptr(lnb), ptr(vbuf), out.data_ptr(),
            rows, c, int(gelu == "hp"), MODES.index(folded.mode) + 1, _stream(dev))
    _build.check(err, what)
    ln_mlp_residual_int8.launches += 1
    return out


ln_mlp_residual_int8.launches = 0
