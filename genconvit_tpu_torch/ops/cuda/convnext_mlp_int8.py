"""K4: the ConvNeXt block tail with int8 matmuls as a hand-written CUDA
kernel (csrc/convnext_mlp_int8.cu), with its plain PyTorch version.

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
the rounded ones), once, at engine construction (`fold_block_mlp_int8`).
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. It counts its launches in
`ln_mlp_residual_int8.launches`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from genconvit_tpu_torch.ops.act import gelu_rational_f32
from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda.convnext_mlp import (MAX_C, _check_rows,
                                                       _check_vec, _require,
                                                       _row_moments, _stream,
                                                       fold_block_mlp_f32)
from genconvit_tpu_torch.ops.quant import (FIXED_ACT_CLIP, quant_cols,
                                           quant_fixed, quant_rows)

MODES = ("fc1", "full")
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


class FoldedMLPInt8(NamedTuple):
    """A block's MLP folded and quantized for one int8 mode. The int8
    matrices keep the torch Linear layout [out, in]."""
    mode: str                      # 'fc1' | 'full'
    wq1: torch.Tensor              # [4C, C] int8: quant_cols(ln_scale * W1)
    s1: torch.Tensor               # [4C] f32 ('fc1': times 8/127)
    bw: torch.Tensor               # [4C] f32: ln_bias @ W1 + b1
    w2g: Optional[torch.Tensor]    # 'fc1': [4C, C] compute dtype, W2 * gamma
    wq2: Optional[torch.Tensor]    # 'full': [C, 4C] int8: quant_cols(W2 * gamma)
    s2: Optional[torch.Tensor]     # 'full': [C] f32
    b2g: torch.Tensor              # [C] f32: b2 * gamma


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
        return FoldedMLPInt8(mode, wq1, s1.contiguous(), f.bw,
                             f.w2g.to(dtype).contiguous(), None, None, f.b2g)
    wq2, s2 = quant_cols(f.w2g)                 # [4C, C], [C]
    return FoldedMLPInt8(mode, wq1, s1.contiguous(), f.bw, None,
                         wq2.t().contiguous(), s2.contiguous(), f.b2g)


def _int_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 a [..., K] . int8 w [N, K]^T as float32: the product runs in
    float64, exact for |sum| <= 3072 * 127^2 < 2^53, then rounds once to
    float32, as the kernel's int32 -> float32 conversion does."""
    return (a.double() @ w.double().t()).float()


def ln_mlp_residual_int8_plain(dw: torch.Tensor, x: torch.Tensor, folded: FoldedMLPInt8,
                               post_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                               gelu: str = "default") -> torch.Tensor:
    """K4's math in plain PyTorch, with the kernel's rounding points."""
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
        o = _int_dot(hq, folded.wq2) * sb * folded.s2 + folded.b2g
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
    _require(c <= MAX_C, what, f"C={c} exceeds {MAX_C}")
    _require(gelu in ("default", "hp"), what, f"no kernel GELU tier {gelu!r}")
    dev = x.device
    f32 = torch.float32
    _check_vec(what, folded.wq1, (4 * c, c), torch.int8, dev)
    _check_vec(what, folded.s1, (4 * c,), f32, dev)
    _check_vec(what, folded.bw, (4 * c,), f32, dev)
    _check_vec(what, folded.b2g, (c,), f32, dev)
    if folded.mode == "fc1":
        _check_vec(what, folded.w2g, (4 * c, c), torch.bfloat16, dev)
    else:
        _check_vec(what, folded.wq2, (c, 4 * c), torch.int8, dev)
        _check_vec(what, folded.s2, (c,), f32, dev)
    lns = lnb = None
    if post_ln is not None:
        lns, lnb = post_ln
        _check_vec(what, lns, (c,), f32, dev)
        _check_vec(what, lnb, (c,), f32, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.gcv_ln_mlp_residual_int8(
            dw.data_ptr(), x.data_ptr(), folded.wq1.data_ptr(), folded.s1.data_ptr(),
            folded.bw.data_ptr(), ptr(folded.w2g), ptr(folded.wq2), ptr(folded.s2),
            folded.b2g.data_ptr(), ptr(lns), ptr(lnb), out.data_ptr(),
            x.numel() // c, c, int(gelu == "hp"), MODES.index(folded.mode) + 1,
            _stream(dev))
    _build.check(err, what)
    ln_mlp_residual_int8.launches += 1
    return out


ln_mlp_residual_int8.launches = 0
