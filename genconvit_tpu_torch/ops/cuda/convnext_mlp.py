"""K1 and K2: the ConvNeXt block tail and the row LayerNorm as hand-written
CUDA kernels (csrc/convnext_mlp.cu), with their plain PyTorch versions.

  ln_mlp_residual  replaces fused_ln_mlp_residual (_mlp_kernel,
                   _mlp_kernel_post_ln) of genconvit_tpu/ops/pallas/convnext_mlp.py
  layer_norm_rows  replaces layer_norm_rows (_ln_rows_kernel) of the same file

Each wrapper takes the JAX package's layout, [..., C] with C last. On a CPU
tensor it runs the plain version (the same math with the same rounding
points); on a CUDA tensor it launches the kernel or raises. Each keeps a
count of its kernel launches in its `launches` attribute, raised where it
launches and nowhere else.

The kernel's bounds and design are in the note at the top of the CUDA
source. The LayerNorm affine folds into fc1 and the layer scale into fc2
(`fold_block_mlp`), once, at engine construction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from genconvit_tpu_torch.ops.act import gelu_rational_f32
from genconvit_tpu_torch.ops.cuda import _build

LN_EPS = 1e-6
MAX_C = 768  # the fc2 accumulator tile holds [16, 768] f32 at the widest
ULP_TOL = 2.0  # kernel vs plain, elementwise, in bf16 ulps (bf16_ulp_error)


class FoldedMLP(NamedTuple):
    """A block's MLP with its LayerNorm affine and layer scale folded in."""
    wg: torch.Tensor    # [C, 4C] compute dtype: ln_scale[:, None] * W1
    bw: torch.Tensor    # [4C] f32: ln_bias @ W1 + b1
    w2g: torch.Tensor   # [4C, C] compute dtype: W2 * gamma[None, :]
    b2g: torch.Tensor   # [C] f32: b2 * gamma


def fold_block_mlp(ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                   fc2_bias, gamma, dtype: torch.dtype) -> FoldedMLP:
    """Fold in float32 from the given (torch-layout) weights, then store the
    two matrices in `dtype` (as convnext_mlp.py:388-397 does)."""
    w1 = fc1_weight.float().t()                  # [C, 4C]
    gam = gamma.float()
    wg = (ln_scale.float()[:, None] * w1).to(dtype).contiguous()
    bw = (ln_bias.float() @ w1 + fc1_bias.float()).contiguous()
    w2g = (fc2_weight.float().t() * gam[None, :]).to(dtype).contiguous()
    b2g = (fc2_bias.float() * gam).contiguous()
    return FoldedMLP(wg, bw, w2g, b2g)


def _row_moments(v32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rsqrt(var + eps)) over the last axis, var = E[v^2] - mean^2."""
    mean = v32.mean(-1, keepdim=True)
    var = (v32 * v32).mean(-1, keepdim=True) - mean * mean
    return mean, torch.rsqrt(var + LN_EPS)


def ln_mlp_residual_plain(dw: torch.Tensor, x: torch.Tensor, folded: FoldedMLP,
                          post_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          gelu: str = "default") -> torch.Tensor:
    """K1's math in plain PyTorch. bf16 operands are upcast before each
    matmul: their products are exact in float32, so this is the kernel's
    bf16-in, f32-accumulate product."""
    dtype = x.dtype
    d32 = dw.float()
    mean, inv = _row_moments(d32)
    y = ((d32 - mean) * inv).to(dtype)
    z = y.float() @ folded.wg.float() + folded.bw
    h = gelu_rational_f32(z, gelu).to(dtype)
    o = h.float() @ folded.w2g.float() + folded.b2g
    if post_ln is None:
        return x + o.to(dtype)
    out = x.float() + o
    m2, inv2 = _row_moments(out)
    return ((out - m2) * inv2 * post_ln[0].float() + post_ln[1].float()).to(dtype)


def layer_norm_rows_plain(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """K2's math in plain PyTorch: f32 statistics and affine."""
    v = x.float()
    mean, inv = _row_moments(v)
    return ((v - mean) * inv * scale.float() + bias.float()).to(x.dtype)


def bf16_ulp_error(out: torch.Tensor, ref: torch.Tensor,
                   x: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> float:
    """max over elements of |out - ref| in bf16 ulps: how a kernel is held
    against its plain version. Both round at the same points, so they
    differ only where float32 summation order flips a rounding. A flip of
    the output costs an ulp of the element: of max(|ref|, |x|) for a
    residual output x + o, so that cancellation in the sum does not shrink
    it. A flip of a rounded intermediate (K1's y or h) moves every element
    that depends on it by a small fraction of an ulp of the largest value
    computed from it: `scale`, below which no element's ulp is taken (K1:
    max|bf16(o)| of the MLP branch, or max|ref| after the post-LN). Without
    `scale` (an output computed in float32 from its bf16 inputs, as K2's)
    the floor is max|ref| / 128, where float32 noise stays far below an
    ulp."""
    ref32 = ref.float()
    mag = ref32.abs()
    floor = mag.max() / 128 if scale is None else torch.tensor(float(scale))
    if x is not None:
        mag = torch.maximum(mag, x.float().abs())
    _, exp = torch.frexp(torch.maximum(mag, floor.to(mag.device)))
    ulp = torch.ldexp(torch.ones_like(mag), exp - 8)   # 8 significant bits
    return ((out.float() - ref32).abs() / ulp).max().item()


def _require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_rows(what: str, *ts: torch.Tensor) -> None:
    ref = ts[0]
    c = ref.shape[-1]
    _require(c % 32 == 0, what, f"C={c} must be a multiple of 32")
    for t in ts:
        _require(t.device == ref.device, what, "tensors on different devices")
        _require(t.dtype == torch.bfloat16, what, f"rows must be bfloat16, got {t.dtype}")
        _require(t.shape == ref.shape, what, f"shape {tuple(t.shape)} != {tuple(ref.shape)}")
        _require(t.is_contiguous(), what, "rows must be contiguous")
        _require(t.data_ptr() % 16 == 0, what, "rows must be 16-byte aligned")


def _check_vec(what: str, t: torch.Tensor, shape, dtype, device) -> None:
    _require(t.device == device, what, "weights on another device than the rows")
    _require(t.dtype == dtype, what, f"expected {dtype}, got {t.dtype}")
    _require(tuple(t.shape) == tuple(shape), what,
             f"expected shape {tuple(shape)}, got {tuple(t.shape)}")
    _require(t.is_contiguous(), what, "weights must be contiguous")
    _require(t.data_ptr() % 32 == 0, what, "weights must be 32-byte aligned")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ln_mlp_residual(dw: torch.Tensor, x: torch.Tensor, folded: FoldedMLP,
                    post_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    gelu: str = "default") -> torch.Tensor:
    """K1: block tail of a ConvNeXt block. dw = depthwise-conv output and
    x = block input, both [..., C]; returns the block output (or, with
    post_ln=(scale, bias), its LayerNorm with those f32 params)."""
    if dw.device.type == "cpu" and x.device.type == "cpu":
        return ln_mlp_residual_plain(dw, x, folded, post_ln, gelu)
    what = "ln_mlp_residual"
    _require(dw.is_cuda, what, f"unsupported device {dw.device}")
    _check_rows(what, dw, x)
    c = x.shape[-1]
    _require(c <= MAX_C, what, f"C={c} exceeds {MAX_C}")
    _require(gelu in ("default", "hp"), what, f"no kernel GELU tier {gelu!r}")
    dev = x.device
    _check_vec(what, folded.wg, (c, 4 * c), torch.bfloat16, dev)
    _check_vec(what, folded.bw, (4 * c,), torch.float32, dev)
    _check_vec(what, folded.w2g, (4 * c, c), torch.bfloat16, dev)
    _check_vec(what, folded.b2g, (c,), torch.float32, dev)
    lns = lnb = None
    if post_ln is not None:
        lns, lnb = post_ln
        _check_vec(what, lns, (c,), torch.float32, dev)
        _check_vec(what, lnb, (c,), torch.float32, dev)
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.gcv_ln_mlp_residual(
            dw.data_ptr(), x.data_ptr(), folded.wg.data_ptr(),
            folded.bw.data_ptr(), folded.w2g.data_ptr(), folded.b2g.data_ptr(),
            None if lns is None else lns.data_ptr(),
            None if lnb is None else lnb.data_ptr(),
            out.data_ptr(), x.numel() // c, c, int(gelu == "hp"), _stream(dev))
    _build.check(err, what)
    ln_mlp_residual.launches += 1
    return out


ln_mlp_residual.launches = 0


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """K2: LayerNorm over the last axis of [..., C] with f32 (scale, bias)."""
    if x.device.type == "cpu":
        return layer_norm_rows_plain(x, scale, bias)
    what = "layer_norm_rows"
    _require(x.is_cuda, what, f"unsupported device {x.device}")
    _check_rows(what, x)
    c = x.shape[-1]
    _check_vec(what, scale, (c,), torch.float32, x.device)
    _check_vec(what, bias, (c,), torch.float32, x.device)
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.gcv_layer_norm_rows(x.data_ptr(), scale.data_ptr(),
                                      bias.data_ptr(), out.data_ptr(),
                                      x.numel() // c, c, _stream(x.device))
    _build.check(err, what)
    layer_norm_rows.launches += 1
    return out


layer_norm_rows.launches = 0


def row_tile(c: int) -> int:
    """Rows per block K1 uses at width c (loads the library)."""
    return _build.load().gcv_mlp_row_tile(c)


def reset_launch_counts() -> None:
    ln_mlp_residual.launches = 0
    layer_norm_rows.launches = 0


def launch_counts() -> dict:
    return {"ln_mlp_residual": ln_mlp_residual.launches,
            "layer_norm_rows": layer_norm_rows.launches}
