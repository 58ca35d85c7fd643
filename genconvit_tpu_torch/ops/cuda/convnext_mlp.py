"""K1 and K2: the ConvNeXt block tail and the row LayerNorm as hand-written
CUDA kernels (csrc/convnext_mlp.cu, csrc/layer_norm_rows.cu), with their
plain PyTorch versions.

  ln_mlp_residual  replaces fused_ln_mlp_residual (_mlp_kernel,
                   _mlp_kernel_post_ln) of genconvit_tpu/ops/pallas/convnext_mlp.py
  layer_norm_rows  replaces layer_norm_rows (_ln_rows_kernel) of the same file

Each wrapper takes the JAX package's layout, [..., C] with C last. On a CPU
tensor it runs the plain version (the same math with the same rounding
points); on a CUDA tensor it launches the kernel or raises. Each keeps a
count of its kernel launches in its `launches` attribute, raised where it
launches and nowhere else.

The kernels' bounds and designs are in the notes at the top of the CUDA
sources. K1 has two routes, chosen by the width and the post-LN alone
(`k1_route`): the fused loop (csrc/mlp_wgmma.cuh), and, where that loop
would compute fc1 more than once, one persistent launch of ordered LN, fc1
and fc2 tiles that hands the hidden on through a scratch in device memory
(csrc/mlp_ordered.cuh); `ln_mlp_residual.ordered_launches` counts the
latter. K2 has its own instantiations at the stem widths K2_WIDTHS and
one generic instantiation for every other multiple of 32 (`k2_plan`). The
LayerNorm affine folds into fc1 and the layer scale into fc2
(`fold_block_mlp`), once, at engine construction. Both kernels take the
LayerNorm eps as an argument: ConvNeXt's LN_EPS by default, Swin's 1e-5
from models/swin.py (a Swin MLP half is K1 with dw = x and a unit layer
scale).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from genconvit_tpu_torch.ops.act import gelu_rational_f32
from genconvit_tpu_torch.ops.cuda import _build

LN_EPS = 1e-6   # ConvNeXt's LayerNorms; the wrappers' default eps
K1_MAX_C = 1536  # K1 splits its fc2 sum into output-column groups (mlp_plan)
ULP_TOL = 2.0  # kernel vs plain, elementwise, in bf16 ulps (bf16_ulp_error)
K2_WIDTHS = (96, 128, 192)  # the stems of convnext_tiny, _base and _large


class K2Plan(NamedTuple):
    """K2's instantiation at a width (csrc/layer_norm_rows.cu gcv_k2_plan)."""
    lanes: int     # lanes per row
    chunks: int    # 16-byte chunks a lane holds in registers
    generic: int   # 1: the generic instantiation (columns past lanes x chunks x 8 read twice)


def k2_plan(c: int) -> Optional[K2Plan]:
    """K2's instantiation at width c, chosen by the width alone; None where
    K2 does not take c (not a positive multiple of 32)."""
    if c <= 0 or c % 32:
        return None
    return {96: K2Plan(4, 3, 0), 128: K2Plan(4, 4, 0), 192: K2Plan(8, 3, 0)}.get(
        c, K2Plan(32, 4, 1))


def library_k2_plan(c: int) -> Optional[K2Plan]:
    """K2's instantiation as the built library chooses it (loads the library)."""
    out = (ctypes.c_int * 3)()
    return K2Plan(*out) if _build.load().gcv_k2_plan(c, out) else None


class FoldedMLP(NamedTuple):
    """A block's MLP with its LayerNorm affine and layer scale folded in.
    K1 reads the two matrices transposed (K-major, as warpgroup MMA takes
    its B operand): `fold_block_mlp` stores both layouts."""
    wg: torch.Tensor    # [C, 4C] compute dtype: ln_scale[:, None] * W1
    bw: torch.Tensor    # [4C] f32: ln_bias @ W1 + b1
    w2g: torch.Tensor   # [4C, C] compute dtype: W2 * gamma[None, :]
    b2g: torch.Tensor   # [C] f32: b2 * gamma
    wgt: Optional[torch.Tensor] = None    # [4C, C]: wg transposed, contiguous
    w2gt: Optional[torch.Tensor] = None   # [C, 4C]: w2g transposed, contiguous


class MlpPlan(NamedTuple):
    """K1's tile plan at one width (csrc/mlp_wgmma.cuh mlp_wgmma_plan)."""
    rows: int     # rows per block: 128 (two warpgroups of 64) or 64 (shared)
    cols: int     # output columns per fc2 group
    stages: int   # weight ring stages
    smem: int     # dynamic shared memory bytes

    def passes(self, c: int) -> int:
        """Passes over the hidden dimension per row tile (fc1 once each):
        every group in turn with 128 rows, two groups at once with 64."""
        groups = -(-c // self.cols)
        return groups if self.rows == 128 else -(-groups // 2)

    def streams(self, c: int) -> bool:
        """Whether the ring is too short for a turn (all fc1 stages of a
        chunk and its fc2 stages at once): then K1 streams stage by stage
        and its two warpgroups take no turns at the tensor cores."""
        kbs = 2 if self.cols < 128 else self.cols // 64
        return self.stages < -(-((c + 63) // 64) // kbs) + (1 if self.rows == 128 else 2)


_SMEM_MAX = 232448
_SMEM_MISC = 1152   # mbarriers and the row sums of the post-LN


@functools.lru_cache(maxsize=None)
def mlp_plan(c: int) -> Optional[MlpPlan]:
    """K1's tile plan at width c, as the CUDA source computes it; None where
    K1 does not take c (a multiple of 32 in [32, K1_MAX_C])."""
    if c < 32 or c > K1_MAX_C or c % 32:
        return None
    rows = 128 if c <= 384 else 64
    ybytes = rows * ((c + 63) // 64) * 128

    def stage_bytes(nc):   # NC rows of 128 bytes, or the fc1 tiles of a stage
        return max(nc * 128, (2 if nc < 128 else nc // 64) * 8192)

    def stages(nc):
        return min(8, (_SMEM_MAX - 1024 - ybytes - _SMEM_MISC) // stage_bytes(nc))

    best = None
    for nc in ((192, 128, 96) if rows == 128 else (192, 128)):
        if stages(nc) < 2:
            continue
        groups = -(-c // nc)
        cost = (groups if rows == 128 else -(-groups // 2) * 2) * nc
        if best is None or cost < best[1]:
            best = (nc, cost)
    if best is None:
        return None
    nc = best[0]
    st = stages(nc)
    return MlpPlan(rows, nc, st, 1024 + ybytes + st * stage_bytes(nc) + _SMEM_MISC)


def k1_route(c: int, post_ln: bool) -> bool:
    """Whether K1 takes its ordered route at width c: where the fused plan
    makes more than one pass over the hidden dimension and no post-LN is
    asked for. The wrapper decides, since it allocates the route's scratch;
    the library takes the route when the scratch is passed."""
    plan = mlp_plan(c)
    return plan is not None and plan.passes(c) > 1 and not post_ln


ORD_ROWS = 128   # rows of the ordered route's row block


def k1_scratch_shapes(rows: int, c: int, post_ln: bool) -> Tuple[Tuple[int, int], ...]:
    """The bf16 scratch K1 asks for: y [rows, C] and the hidden [rows, 4C] on
    the ordered route, none on the fused loop."""
    return ((rows, c), (rows, 4 * c)) if k1_route(c, post_ln) else ()


def k1_flag_words(rows: int, c: int) -> int:
    """The ordered route's readiness flags past its two counters: for each
    128-row block, its LN's and its 4C / 128 fc1 tiles' (csrc/mlp_ordered.cuh
    ord_flags)."""
    return -(-rows // ORD_ROWS) * (1 + 4 * c // 128)


class _Flags:
    """The ordered route's readiness words on one device and stream: zeroed
    once when made (or grown), then handed a new generation each launch, so
    nothing is cleared between launches. They outlive each call (that is
    what lets a generation stand in for clearing), so the module keeps one
    set per device and stream: launches on one stream run in order, and two
    streams never share a set. Threads share a stream (torch's default), so
    a set and its generation are taken under _FLAGS_LOCK."""

    def __init__(self, words: int, device: torch.device):
        self.words = torch.zeros(words, dtype=torch.int64, device=device)
        self.gen = 0

    def next_gen(self) -> int:
        # 1 .. 2**64 - 1, never 0: the kernel compares 64-bit words, so no
        # run lives to see a generation come round again
        self.gen = self.gen % 0xFFFFFFFFFFFFFFFF + 1
        return self.gen


_FLAGS: dict = {}   # (device index, stream handle) -> _Flags
_FLAGS_LOCK = threading.Lock()


def _flags_and_gen(dev: torch.device, stream: int, words: int,
                   stale: bool = False) -> Tuple[torch.Tensor, int]:
    """The set of readiness words for this device and stream, at least
    2 + words long, and a generation for one launch on it: a new one, or
    with `stale` the set's last (a planted fault)."""
    key = (dev.index, stream)
    with _FLAGS_LOCK:
        f = _FLAGS.get(key)
        if f is None or f.words.numel() < 2 + words:
            old = 0 if f is None else f.words.numel()
            f = _Flags(max(2 + words, 2 * old, 1 << 16), dev)
            _FLAGS[key] = f
        return f.words, (f.gen if stale and f.gen else f.next_gen())


def fold_block_mlp_f32(ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                       fc2_bias, gamma) -> FoldedMLP:
    """The folds in float32 from the given (torch-layout) weights, as
    convnext_mlp.py:388-397 computes them: wg32 [C, 4C], bw, w2g32 [4C, C],
    b2g."""
    w1 = fc1_weight.float().t()                  # [C, 4C]
    gam = gamma.float()
    wg = ln_scale.float()[:, None] * w1
    bw = (ln_bias.float() @ w1 + fc1_bias.float()).contiguous()
    w2g = fc2_weight.float().t() * gam[None, :]
    b2g = (fc2_bias.float() * gam).contiguous()
    return FoldedMLP(wg, bw, w2g, b2g)


def fold_block_mlp(ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                   fc2_bias, gamma, dtype: torch.dtype) -> FoldedMLP:
    """Fold in float32, then store the two matrices in `dtype`."""
    f = fold_block_mlp_f32(ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                           fc2_bias, gamma)
    wg, w2g = f.wg.to(dtype), f.w2g.to(dtype)
    return f._replace(wg=wg.contiguous(), w2g=w2g.contiguous(),
                      wgt=wg.t().contiguous(), w2gt=w2g.t().contiguous())


def _row_moments(v32: torch.Tensor, eps: float = LN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rsqrt(var + eps)) over the last axis, var = E[v^2] - mean^2."""
    mean = v32.mean(-1, keepdim=True)
    var = (v32 * v32).mean(-1, keepdim=True) - mean * mean
    return mean, torch.rsqrt(var + eps)


def ln_mlp_residual_plain(dw: torch.Tensor, x: torch.Tensor, folded: FoldedMLP,
                          post_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          gelu: str = "default", eps: float = LN_EPS) -> torch.Tensor:
    """K1's math in plain PyTorch. bf16 operands are upcast before each
    matmul: their products are exact in float32, so this is the kernel's
    bf16-in, f32-accumulate product."""
    dtype = x.dtype
    d32 = dw.float()
    mean, inv = _row_moments(d32, eps)
    y = ((d32 - mean) * inv).to(dtype)
    z = y.float() @ folded.wg.float() + folded.bw
    h = gelu_rational_f32(z, gelu).to(dtype)
    o = h.float() @ folded.w2g.float() + folded.b2g
    if post_ln is None:
        return x + o.to(dtype)
    out = x.float() + o
    m2, inv2 = _row_moments(out, eps)
    return ((out - m2) * inv2 * post_ln[0].float() + post_ln[1].float()).to(dtype)


def layer_norm_rows_plain(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """K2's math in plain PyTorch: f32 statistics and affine."""
    v = x.float()
    mean, inv = _row_moments(v, eps)
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
                    gelu: str = "default", eps: float = LN_EPS) -> torch.Tensor:
    """K1: block tail of a ConvNeXt block. dw = depthwise-conv output and
    x = block input, both [..., C]; returns the block output (or, with
    post_ln=(scale, bias), its LayerNorm with those f32 params). eps: the
    LayerNorms' (a Swin MLP half passes dw = x and 1e-5)."""
    if dw.device.type == "cpu" and x.device.type == "cpu":
        return ln_mlp_residual_plain(dw, x, folded, post_ln, gelu, eps)
    lns, lnb = _check_k1("ln_mlp_residual", dw, x, folded, post_ln, gelu)
    return _launch_k1(dw, x, folded, lns, lnb, gelu, eps, 0, False)


def _check_k1(what, dw, x, folded, post_ln, gelu):
    """K1's argument checks; returns the post-LN (scale, bias) or Nones."""
    _require(dw.is_cuda, what, f"unsupported device {dw.device}")
    _check_rows(what, dw, x)
    c = x.shape[-1]
    plan = mlp_plan(c)
    _require(plan is not None, what, f"C={c} exceeds {K1_MAX_C}")
    _require(gelu in ("default", "hp"), what, f"no kernel GELU tier {gelu!r}")
    _require(folded.wgt is not None and folded.w2gt is not None, what,
             "the folds lack the transposed matrices (make them with fold_block_mlp)")
    dev = x.device
    _check_vec(what, folded.wgt, (4 * c, c), torch.bfloat16, dev)
    _check_vec(what, folded.bw, (4 * c,), torch.float32, dev)
    _check_vec(what, folded.w2gt, (c, 4 * c), torch.bfloat16, dev)
    _check_vec(what, folded.b2g, (c,), torch.float32, dev)
    lns = lnb = None
    if post_ln is not None:
        lns, lnb = post_ln
        _check_vec(what, lns, (c,), torch.float32, dev)
        _check_vec(what, lnb, (c,), torch.float32, dev)
    return lns, lnb


def _launch_k1(dw, x, folded, lns, lnb, gelu, eps, plant, stale_gen):
    """One K1 launch on checked arguments; plant and stale_gen are the
    planted faults of `ln_mlp_residual_planted`."""
    c = x.shape[-1]
    dev = x.device
    post = lns is not None
    out = torch.empty_like(x)
    rows = x.numel() // c
    # post-LN over more than one pass keeps x + o in float32 here
    vbuf = (torch.empty((rows, c), dtype=torch.float32, device=dev)
            if post and mlp_plan(c).passes(c) > 1 else None)
    scratch = k1_scratch_shapes(rows, c, post)   # the ordered route's, or none
    lib = _build.load()
    stream = _stream(dev)
    ptrs = (dw.data_ptr(), x.data_ptr(), folded.wgt.data_ptr(), folded.bw.data_ptr(),
            folded.w2gt.data_ptr(), folded.b2g.data_ptr())
    if scratch:
        poison = bool(plant or stale_gen)   # planted: a stale read shows as NaN
        ybuf, hbuf = (torch.full(shape, float("nan"), dtype=torch.bfloat16, device=dev)
                      if poison else torch.empty(shape, dtype=torch.bfloat16, device=dev)
                      for shape in scratch)
        flags, gen = _flags_and_gen(dev, stream, k1_flag_words(rows, c), stale_gen)
        ord_ptrs = (ybuf.data_ptr(), hbuf.data_ptr(), flags.data_ptr())
        with torch.cuda.device(dev):
            if plant:
                err = lib.gcv_ln_mlp_residual_planted(*ptrs, out.data_ptr(), *ord_ptrs, rows, c,
                                                      int(gelu == "hp"), eps, gen, plant, stream)
            else:
                err = lib.gcv_ln_mlp_residual(*ptrs, None, None, None, out.data_ptr(),
                                              *ord_ptrs, rows, c, int(gelu == "hp"), eps, gen,
                                              stream)
        _build.check(err, "ln_mlp_residual")
        ln_mlp_residual.launches += 1
        ln_mlp_residual.ordered_launches += 1
        return out
    with torch.cuda.device(dev):
        err = lib.gcv_ln_mlp_residual(
            *ptrs, None if lns is None else lns.data_ptr(),
            None if lnb is None else lnb.data_ptr(),
            None if vbuf is None else vbuf.data_ptr(),
            out.data_ptr(), None, None, None, rows, c, int(gelu == "hp"), eps, 0, stream)
    _build.check(err, "ln_mlp_residual")
    ln_mlp_residual.launches += 1
    return out


ln_mlp_residual.launches = 0
ln_mlp_residual.ordered_launches = 0   # of `launches`, those on the ordered route

# The ordered route's planted faults (`ln_mlp_residual_planted`, through
# the library's gcv_ln_mlp_residual_planted), each of which the card tests
# must see fail: the readiness waits skipped, and the previous launch's
# generation passed again (its words already read ready). Both hand the
# items out row block by row block, where a reader follows its writer at
# once (the phase order would hide a missing wait most of the time), and
# fill the scratch with NaN first, so that a stale read shows. "row_order"
# alone keeps the waits and a new generation: a sound launch, in which
# every item waits on the one before it, for the tests that stress the
# route's hand-overs.
ORDERED_PLANTS = ("no_wait", "stale_gen")
_PLANT_BITS = {"no_wait": 3, "stale_gen": 2, "row_order": 2}   # gcv_ln_mlp_residual_planted


def ln_mlp_residual_planted(dw: torch.Tensor, x: torch.Tensor, folded: FoldedMLP,
                            plant: str, gelu: str = "default", eps: float = LN_EPS) -> torch.Tensor:
    """K1 on the ordered route with one of ORDERED_PLANTS planted, or in
    "row_order" (sound)."""
    what = "ln_mlp_residual_planted"
    _require(plant in _PLANT_BITS, what, f"no plant {plant!r}")
    _check_k1(what, dw, x, folded, None, gelu)
    _require(k1_route(x.shape[-1], False), what, "the plants are of the ordered route")
    return _launch_k1(dw, x, folded, None, None, gelu, eps, _PLANT_BITS[plant],
                      plant == "stale_gen")


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """K2: LayerNorm over the last axis of [..., C] with f32 (scale, bias)
    and the LayerNorm's eps."""
    if x.device.type == "cpu":
        return layer_norm_rows_plain(x, scale, bias, eps)
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
                                      x.numel() // c, c, eps, _stream(x.device))
    _build.check(err, what)
    layer_norm_rows.launches += 1
    return out


layer_norm_rows.launches = 0


def row_tile(c: int) -> int:
    """Rows per block K1 uses at width c."""
    return mlp_plan(c).rows


def library_plan(c: int) -> Optional[MlpPlan]:
    """K1's tile plan as the built library computes it (loads the library);
    the card tests hold `mlp_plan` against it."""
    out = (ctypes.c_int * 4)()
    return MlpPlan(*out) if _build.load().gcv_mlp_plan(c, out) else None
