"""K5: one whole ConvNeXt block as a hand-written CUDA kernel
(csrc/convnext_block.cu), with its plain PyTorch version.

  fused_convnext_block  replaces fused_convnext_block (_block_kernel) of
                        genconvit_tpu/ops/pallas/convnext_block.py

Per pixel of an NHWC activation x [N,H,W,C], in this order and with these
roundings (convnext_block.py:71-98):

  acc = b_dw + sum over (dy, dx) of x[., y+dy-3, x+dx-3, .] * w_dw[dy, dx]
        float32 from the bias, taps in (dy, dx) order, zero padding 3
  y   = bf16(((acc - mean) * rsqrt(var + 1e-6)) * ln_scale + ln_bias),
        var = E[acc^2] - mean^2 (one pass; not folded into fc1)
  h   = bf16(GELU(y . w1 + b1)), the erf form with the hp rational erf and
        an exact divide, whatever the plan's GELU tier
  out = bf16(x + ((h . w2 + b2) * gamma))   (gamma not folded into w2)

The kernel runs the GELU's polynomials on fused multiply-adds (one
rounding where the plain version rounds twice: a few float32 ulps of the
erf, below h's bf16 rounding; the kernel is held to the plain version
within ULP_TOL). The wrapper takes the JAX layout [N,H,W,C], which is the
storage of the port's channels_last NCHW activations. On a CPU tensor it runs the plain
version; on a CUDA tensor it launches the kernel or raises. It counts its
kernel launches in its `launches` attribute.

`pack_block` lays a block's weights out as K5 and K6 read them, once, in
`ConvNeXt.prepare_kernels()`; `stack_blocks` stacks a chain's packs on a
leading axis for K6 (ops/cuda/convnext_stage.py). `planted_faults` makes
the wrong packs that the card checks must refuse. `k5_plan` mirrors the
kernel's plan (csrc/block_wgmma.cuh: K1's tile plan and the taps' register
blocking); `library_k5_plan` asks the built library.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from genconvit_tpu_torch.ops.act import _SQRT_HALF, erf_rational
from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda.convnext_mlp import (K1_MAX_C, LN_EPS, _check_vec,
                                                       _require, _stream, mlp_plan)

ULP_TOL = 2.0  # kernel vs plain, elementwise, in bf16 ulps: one rounding of x + o, as K1


class FusedBlockWeights(NamedTuple):
    """A block's weights as K5 reads them; K6 reads the same fields stacked
    on a leading axis of the chain's blocks. The kernels read the matrices
    K-major, as warpgroup MMA takes its B operand (w1t, w2t: the torch
    layouts, which `pack_block` stores); w1 and w2 hold the same values
    transposed, as the plain version reads them."""
    w_dw: torch.Tensor    # [49, C] bf16: w_dw[dy*7+dx, c] = conv_dw.weight[c, 0, dy, dx]
    b_dw: torch.Tensor    # [C] f32
    ln_scale: torch.Tensor  # [C] f32
    ln_bias: torch.Tensor   # [C] f32
    w1: torch.Tensor      # [C, 4C] bf16: fc1.weight^T
    b1: torch.Tensor      # [4C] f32
    w2: torch.Tensor      # [4C, C] bf16: fc2.weight^T
    b2: torch.Tensor      # [C] f32
    gamma: torch.Tensor   # [C] f32
    w1t: Optional[torch.Tensor] = None   # [4C, C] bf16: fc1.weight (= w1^T)
    w2t: Optional[torch.Tensor] = None   # [C, 4C] bf16: fc2.weight (= w2^T)


@torch.no_grad()
def pack_block(conv_dw_weight, conv_dw_bias, ln_scale, ln_bias, fc1_weight, fc1_bias,
               fc2_weight, fc2_bias, gamma, dtype: torch.dtype) -> FusedBlockWeights:
    """The block's (torch-layout) weights as K5 reads them: the matrices in
    `dtype`, the vectors in float32 (of the weights' own values)."""
    c = conv_dw_weight.shape[0]

    def vec(t):
        return t.float().contiguous()

    return FusedBlockWeights(
        w_dw=conv_dw_weight[:, 0].permute(1, 2, 0).reshape(49, c).to(dtype).contiguous(),
        b_dw=vec(conv_dw_bias), ln_scale=vec(ln_scale), ln_bias=vec(ln_bias),
        w1=fc1_weight.t().to(dtype).contiguous(), b1=vec(fc1_bias),
        w2=fc2_weight.t().to(dtype).contiguous(), b2=vec(fc2_bias), gamma=vec(gamma),
        w1t=fc1_weight.to(dtype).contiguous(), w2t=fc2_weight.to(dtype).contiguous())


@torch.no_grad()
def stack_blocks(packs: Sequence[FusedBlockWeights]) -> FusedBlockWeights:
    """A chain's packs stacked on a leading axis, as K6 reads them."""
    return FusedBlockWeights(*(None if f[0] is None else torch.stack(f).contiguous()
                               for f in zip(*packs)))


def planted_faults(p: FusedBlockWeights) -> Dict[str, FusedBlockWeights]:
    """The pack p each missing one term of K5's math, as a kernel that
    forgot it would read it: the check of a kernel against its plain
    version must refuse every one."""
    w_t = p.w_dw.reshape(7, 7, -1).transpose(0, 1).reshape(49, -1).contiguous()
    return {"dw bias dropped": p._replace(b_dw=torch.zeros_like(p.b_dw)),
            "dw kernel transposed": p._replace(w_dw=w_t),
            "LN bias dropped": p._replace(ln_bias=torch.zeros_like(p.ln_bias)),
            "layer scale 1": p._replace(gamma=torch.ones_like(p.gamma))}


def gelu_erf_hp(h: torch.Tensor) -> torch.Tensor:
    """K5's GELU: 0.5 * h * (1 + erf(h / sqrt(2))) with the hp rational erf,
    e = zc * (P / Q) (convnext_block.py:35-41, :92)."""
    return 0.5 * h * (1.0 + erf_rational(h * _SQRT_HALF, "hp"))


def block_plain(x: torch.Tensor, p: FusedBlockWeights,
                gelu: Callable[[torch.Tensor], torch.Tensor], stop: str = "full") -> torch.Tensor:
    """One block's math on NHWC x, rounded where the kernels round: K5 with
    gelu_erf_hp, each block of K6 with its own GELU form. bf16 operands are
    upcast before each product: a bf16 product is exact in float32. `stop`
    cuts it after a step, as the block-phase probe (ops/cuda/block_parts.py)
    does: 'dw', 'ln', 'fc1' or 'gelu' return that step's output in x's
    dtype (the hidden's first C columns for 'fc1' and 'gelu')."""
    dtype = x.dtype
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 3, 3, 3, 3))
    acc = p.b_dw.float().expand(n, h, w, c)
    for dy in range(7):
        for dx in range(7):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :].float() * p.w_dw[dy * 7 + dx].float()
    if stop == "dw":
        return acc.to(dtype)
    inv_c = 1.0 / c
    mean = acc.sum(-1, keepdim=True) * inv_c
    var = (acc * acc).sum(-1, keepdim=True) * inv_c - mean * mean
    y = (acc - mean) * torch.rsqrt(var + LN_EPS)
    y = (y * p.ln_scale.float() + p.ln_bias.float()).to(dtype)
    if stop == "ln":
        return y
    hid = y.float() @ p.w1.float() + p.b1.float()
    if stop == "fc1":
        return hid[..., :c].to(dtype)
    hid = gelu(hid).to(dtype)
    if stop == "gelu":
        return hid[..., :c]
    o = (hid.float() @ p.w2.float() + p.b2.float()) * p.gamma.float()
    return (x.float() + o).to(dtype)


def fused_convnext_block_plain(x: torch.Tensor, p: FusedBlockWeights) -> torch.Tensor:
    """K5's math in plain PyTorch."""
    return block_plain(x, p, gelu_erf_hp)


def check_activation(what: str, x: torch.Tensor, max_c: int = K1_MAX_C) -> None:
    """What K5, K6 and the probe M2 take: a contiguous 16-byte-aligned bf16
    NHWC tensor with C a multiple of 32 and at most max_c (K1's limit)."""
    _require(x.dim() == 4, what, f"expected [N,H,W,C], got shape {tuple(x.shape)}")
    c = x.shape[-1]
    _require(x.dtype == torch.bfloat16, what, f"x must be bfloat16, got {x.dtype}")
    _require(c % 32 == 0 and c > 0, what, f"C={c} must be a positive multiple of 32")
    _require(c <= max_c, what, f"C={c} exceeds {max_c}")
    _require(x.is_contiguous(), what, "x must be contiguous (NHWC)")
    _require(x.data_ptr() % 16 == 0, what, "x must be 16-byte aligned")


def check_weights(what: str, p: FusedBlockWeights, c: int, device, lead=(),
                  fields: Sequence[str] = FusedBlockWeights._fields) -> None:
    """The packs' shapes, dtypes and placement (lead: K6's chain axis), of
    every field or of `fields`."""
    lead = tuple(lead)
    bf, f32 = torch.bfloat16, torch.float32
    shapes = {"w_dw": ((49, c), bf), "b_dw": ((c,), f32), "ln_scale": ((c,), f32),
              "ln_bias": ((c,), f32), "w1": ((c, 4 * c), bf), "b1": ((4 * c,), f32),
              "w2": ((4 * c, c), bf), "b2": ((c,), f32), "gamma": ((c,), f32),
              "w1t": ((4 * c, c), bf), "w2t": ((c, 4 * c), bf)}
    for name in fields:
        t = getattr(p, name)
        _require(t is not None, what, f"the pack lacks {name} (make it with pack_block)")
        shape, dtype = shapes[name]
        _check_vec(what, t, lead + shape, dtype, device)


def kernel_operands(p: FusedBlockWeights) -> tuple:
    """The packs K5 and K6 read, in their entry points' order."""
    return (p.w_dw, p.b_dw, p.ln_scale, p.ln_bias, p.w1t, p.b1, p.w2t, p.b2, p.gamma)


class FusedPlan(NamedTuple):
    """K5's plan at one width (csrc/block_wgmma.cuh block_plan_out): K1's
    tile plan, and the channel pairs a lane holds in the taps."""
    rows: int       # rows per tile: 128 (two warpgroups of 64) or 64 (shared)
    cols: int       # output columns per fc2 group
    stages: int     # weight ring stages
    smem: int       # dynamic shared memory bytes
    pairs: int      # >= C / 64; up to 3 the taps of a run stay in registers


def block_pairs(c: int) -> int:
    """The taps' channel pairs per lane at width c: one instantiation per
    range of widths."""
    return 2 if c <= 128 else 3 if c <= 192 else 6 if c <= 384 else 12 if c <= 768 else 24


def k5_plan(c: int) -> Optional[FusedPlan]:
    """K5's plan at width c, as the CUDA source computes it; None where K5
    does not take c (a multiple of 32 in [32, K1_MAX_C])."""
    m = mlp_plan(c)
    if m is None:
        return None
    return FusedPlan(*m, block_pairs(c))


def library_k5_plan(c: int) -> Optional[FusedPlan]:
    """K5's plan as the built library computes it (loads the library); the
    card tests hold `k5_plan` against it."""
    out = (ctypes.c_int * 5)()
    return FusedPlan(*out) if _build.load().gcv_k5_plan(c, out) else None


def fused_convnext_block(x: torch.Tensor, p: FusedBlockWeights) -> torch.Tensor:
    """K5: one ConvNeXt block on x [N,H,W,C]; returns [N,H,W,C]."""
    if x.device.type == "cpu":
        return fused_convnext_block_plain(x, p)
    what = "fused_convnext_block"
    _require(x.is_cuda, what, f"unsupported device {x.device}")
    check_activation(what, x)
    n, h, w, c = x.shape
    check_weights(what, p, c, x.device)
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.gcv_fused_block(
            x.data_ptr(), *(t.data_ptr() for t in kernel_operands(p)), out.data_ptr(), n, h, w,
            c, _stream(x.device))
    _build.check(err, what)
    fused_convnext_block.launches += 1
    return out


fused_convnext_block.launches = 0
