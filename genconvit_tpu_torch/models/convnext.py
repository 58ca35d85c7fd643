"""ConvNeXt backbone (port of genconvit_tpu/models/convnext.py).

timm 0.6.5 `convnext_*` as the reference consumes it: stem (4x4/4 conv +
LN), four stages of [LN + 2x2/2 downsample (stages 1-3); blocks of
depthwise 7x7 -> LN -> MLP(4x, GELU) -> layer scale -> residual], head
(global mean -> LN -> fc). Parameter names are timm's.

Five paths, chosen per call as the JAX package chooses them
(convnext.py:182-198, 436-495); the first four need bfloat16 on CUDA:

  * kernel backbone — plan.pallas '' or 'mlpfull' and plan.gelu != 'exact': stem conv ->
    K2 (the stem LN as `layer_norm_rows`); per block the depthwise conv,
    then K1 (`ln_mlp_residual`) on the NHWC rows, or K4
    (`ln_mlp_residual_int8`) when plan.int8_mlp is 'fc1' or 'full'. The last
    block of stages 0-2 fuses the next downsample's LN (`post_ln`), and the
    downsample then runs its conv directly;
  * per-stage kernel path — plan.pallas 'mlp' or 'mlp:<i,j,...>' and
    plan.gelu != 'exact' (JAX _apply_stage, convnext.py:276-325, 436-452):
    plain stem and downsample LNs; in each chosen stage, per block the
    depthwise conv then K1 (or K4) without a fused LN (`stage_mlp`); the
    LN-folded block in the other stages;
  * fused-block backbone — plan.pallas '1': plain stem and downsample LNs;
    K5 (`fused_convnext_block`, the whole block) on every block whose H
    passes `block_kernel_applies`, the LN-folded block
    (`Block.forward_folded`, the JAX package's bf16 block outside its
    kernels) elsewhere;
  * fused-stage backbone — plan.pallas 'stage': plain stem and downsample
    LNs; K6 (`fused_convnext_stage`, one launch per stage's chain) on every
    stage whose (H, C) pass `stage_kernel_applies`, the LN-folded block
    elsewhere;
  * plain graph — everything else (float32, CPU, pallas '0', exact GELU
    with pallas ''): the reference block with two-pass LayerNorm in
    float32 and the LN-folded block in bfloat16, each with the plan's GELU,
    as the JAX package's _block chooses (convnext.py:193-198).

Serving folds or packs the weights once (`prepare_kernels`). Training
(`per_call_folds=True`) takes the same kernels through three autograd Functions that
fold or pack from the tensors of the call, in their forward, and whose
backward is autograd of the reference graph recomputed, as the JAX
package's custom VJPs (convnext.py:160-227, 306-322, 350-433):
`KernelBackbone` (K2 + K1 or K4), `FusedBlock` (K5), `FusedStage` (K6) and
`MlpStage` (a chosen stage of 'mlp...'). The LN-folded blocks around them
fold per call with a graph (`Block.fold_ln`).

The rank-R separable depthwise approximation (plan.dw_rank, ops/dwsep.py)
is inference-only: `add_dw_sep_` gives a block the buffers `dw_row` and
`dw_col`, and `depthwise` runs their R row and column passes in place of
the 7x7 wherever they are present (JAX _dw_conv, convnext.py:86-103): on
the plain paths and before K1/K4. Only the Predictor adds them, as only
the JAX engine does; the training Functions read the exact weights.

Activations are NCHW in channels_last memory, so the NHWC view the kernels
read as [N*H*W, C] rows is the tensor's own storage.
"""

from __future__ import annotations

from typing import (AbstractSet, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch
import torch.nn as nn
import torch.nn.functional as F

from genconvit_tpu_torch.ops.act import gelu
from genconvit_tpu_torch.ops.conv import conv2d
from genconvit_tpu_torch.ops.cuda.convnext_block import (FusedBlockWeights,
                                                         fused_convnext_block,
                                                         pack_block, stack_blocks)
from genconvit_tpu_torch.ops.cuda.convnext_mlp import (FoldedMLP, _row_moments,
                                                       fold_block_mlp,
                                                       layer_norm_rows,
                                                       ln_mlp_residual)
from genconvit_tpu_torch.ops.cuda.convnext_mlp_int8 import (
    FoldedMLPInt8, fold_block_mlp_int8, ln_mlp_residual_int8)
from genconvit_tpu_torch.ops.cuda.convnext_stage import fused_convnext_stage
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
from genconvit_tpu_torch.ops.norm import layer_norm, layer_norm_2d

CONVNEXT_CFGS = {
    "convnext_tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "convnext_small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "convnext_base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "convnext_large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
}

LN_EPS = 1e-6
DEFAULT_PLAN = KernelPlan()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """[N,C,H,W] -> the NHWC view; free under channels_last."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> the NCHW view, channels_last in memory."""
    return x.permute(0, 3, 1, 2)


def f32_product(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d [..., K] . w [K, N] with a float32 result from d's dtype (JAX's
    preferred_element_type=float32): torch.mm's out_dtype for bf16 on CUDA,
    the upcast product elsewhere and wherever a gradient is taken. The same
    numbers up to summation order: a bf16 product is exact in float32."""
    grad = torch.is_grad_enabled() and (d.requires_grad or w.requires_grad)
    if d.is_cuda and d.dtype == torch.bfloat16 and not grad:
        z = torch.mm(d.reshape(-1, d.shape[-1]), w, out_dtype=torch.float32)
        return z.reshape(d.shape[:-1] + (w.shape[-1],))
    return d.float() @ w.float()


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over C of NCHW (timm LayerNorm2d), eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d(x, self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)


class LNFold(NamedTuple):
    """A block's LayerNorm folded into fc1, as the JAX package's
    _block_xla_folded folds it (genconvit_tpu/models/convnext.py:144-150)."""
    wg: torch.Tensor   # [C, 4C] weights' dtype: ln_scale[:, None] * W1
    gw: torch.Tensor   # [4C] f32: ln_scale @ W1
    bw: torch.Tensor   # [4C] f32: ln_bias @ W1 + b1


class BlockTensors(NamedTuple):
    """A block's weights in torch layout, as the functions below take them."""
    dw_weight: torch.Tensor   # [C, 1, 7, 7]
    dw_bias: torch.Tensor     # [C]
    ln_weight: torch.Tensor   # [C]
    ln_bias: torch.Tensor     # [C]
    fc1_weight: torch.Tensor  # [4C, C]
    fc1_bias: torch.Tensor    # [4C]
    fc2_weight: torch.Tensor  # [C, 4C]
    fc2_bias: torch.Tensor    # [C]
    gamma: torch.Tensor       # [C]


# a block's separable depthwise factors: row filters [R, C, 1, 1, 7] and
# column filters [R, C, 1, 7, 1] (ops/dwsep.py)
DwSep = Tuple[torch.Tensor, torch.Tensor]


def depthwise(x: torch.Tensor, t: BlockTensors, sep: Optional[DwSep] = None) -> torch.Tensor:
    """The block's 7x7 depthwise conv; with `sep`, its rank-R separable
    approximation instead (JAX _dw_conv): per rank a 1x7 pass, padding
    (0, 3), then a 7x1 pass, padding (3, 0); the ranks summed, the bias
    added once."""
    c = x.shape[1]
    if sep is None:
        return conv2d(x, t.dw_weight, t.dw_bias, padding=3, groups=c)
    acc = None
    for kr, kc in zip(*sep):
        h = conv2d(conv2d(x, kr, padding=(0, 3), groups=c), kc, padding=(3, 0), groups=c)
        acc = h if acc is None else acc + h
    return acc + t.dw_bias.to(acc.dtype)[:, None, None]


def block_reference(x: torch.Tensor, t: BlockTensors, gelu_tier: str = "default",
                    sep: Optional[DwSep] = None) -> torch.Tensor:
    """The plain block (genconvit_tpu/models/convnext.py:106-115, _block_xla)."""
    h = _nhwc(depthwise(x, t, sep))
    h = layer_norm(h, t.ln_weight, t.ln_bias, LN_EPS)
    h = F.linear(h, t.fc1_weight, t.fc1_bias)
    h = gelu(h, gelu_tier)
    h = F.linear(h, t.fc2_weight, t.fc2_bias)
    h = h * t.gamma.to(h.dtype)
    return x + _nchw(h)


def block_folded(x: torch.Tensor, t: BlockTensors, gelu_tier: str, fold: LNFold,
                 sep: Optional[DwSep] = None) -> torch.Tensor:
    """The block with its LayerNorm folded into fc1, as the JAX package
    runs a bf16 block outside its kernels (_block_xla_folded,
    convnext.py:118-157): one-pass f32 moments of the depthwise output
    d, z = d . wg in f32, y = ((z - mean * gw) * rsqrt(var + eps) + bw)
    in the activations' dtype, then GELU, fc2 and the layer scale in it."""
    d = _nhwc(depthwise(x, t, sep))
    mean, inv = _row_moments(d.float())
    z = f32_product(d, fold.wg)
    h = ((z - mean * fold.gw) * inv + fold.bw).to(x.dtype)
    h = gelu(h, gelu_tier)
    h = F.linear(h, t.fc2_weight, t.fc2_bias)
    h = h * t.gamma.to(h.dtype)
    return x + _nchw(h)


def ln_fold(t: BlockTensors) -> LNFold:
    """The LayerNorm fold of block_folded, in f32 from the given weights; wg
    in the weights' dtype. Differentiable, as the JAX package's fold inside
    the block."""
    w1 = t.fc1_weight.float().t()
    s = t.ln_weight.float()
    return LNFold(wg=(s[:, None] * w1).to(t.fc1_weight.dtype).contiguous(),
                  gw=(s @ w1).contiguous(),
                  bw=(t.ln_bias.float() @ w1 + t.fc1_bias.float()).contiguous())


class Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim)
        self.gamma = nn.Parameter(torch.empty(dim))
        # the separable depthwise factors (ops/dwsep.add_dw_sep_), absent
        # by default; not in the state dict
        self.register_buffer("dw_row", None, persistent=False)
        self.register_buffer("dw_col", None, persistent=False)

    @property
    def dw_sep(self) -> Optional[DwSep]:
        return None if self.dw_row is None else (self.dw_row, self.dw_col)

    def tensors(self) -> BlockTensors:
        return BlockTensors(self.conv_dw.weight, self.conv_dw.bias, self.norm.weight,
                            self.norm.bias, self.mlp.fc1.weight, self.mlp.fc1.bias,
                            self.mlp.fc2.weight, self.mlp.fc2.bias, self.gamma)

    def dw(self, x: torch.Tensor) -> torch.Tensor:
        return depthwise(x, self.tensors(), self.dw_sep)

    def forward(self, x: torch.Tensor, gelu_tier: str = "default") -> torch.Tensor:
        """The plain block (`block_reference`)."""
        return block_reference(x, self.tensors(), gelu_tier, self.dw_sep)

    def forward_folded(self, x: torch.Tensor, gelu_tier: str, fold: LNFold) -> torch.Tensor:
        """The LN-folded block (`block_folded`) with the fold given."""
        return block_folded(x, self.tensors(), gelu_tier, fold, self.dw_sep)

    def fold_ln(self) -> LNFold:
        """`ln_fold` of the current weights: differentiable; prepare_kernels
        stores it without a graph."""
        return ln_fold(self.tensors())

    def _fold_args(self):
        return tuple(self.tensors())[2:]

    def fold(self) -> FoldedMLP:
        """The MLP folds, matrices in the weights' dtype (bf16 on the
        kernel path)."""
        return fold_block_mlp(*self._fold_args(), self.mlp.fc1.weight.dtype)

    def fold_int8(self, mode: str) -> FoldedMLPInt8:
        """The MLP folds of int8 mode 'fc1' or 'full', quantized from the
        float32 folds of the current weights."""
        return fold_block_mlp_int8(*self._fold_args(), mode, self.mlp.fc1.weight.dtype)

    def pack_fused(self) -> FusedBlockWeights:
        """The block's weights as K5 and K6 read them (matrices in the
        weights' dtype, bf16 on the kernel path)."""
        return pack_block(*self.tensors(), self.mlp.fc1.weight.dtype)


class Stage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, downsample: bool):
        super().__init__()
        self.downsample = (nn.Sequential(LayerNorm2d(in_dim),
                                         nn.Conv2d(in_dim, dim, 2, stride=2))
                           if downsample else None)
        self.blocks = nn.Sequential(*[Block(dim) for _ in range(depth)])


class KernelWeights(NamedTuple):
    """What the kernel backbone reads besides the module's own weights:
    f32 LayerNorm params and each block's folded MLP (K1's folds, or K4's
    for int8 mode `int8_mlp`)."""
    stem_ln: Tuple[torch.Tensor, torch.Tensor]
    blocks: List[List[Union[FoldedMLP, FoldedMLPInt8]]]
    post_ln: List[Optional[Tuple[torch.Tensor, torch.Tensor]]]
    int8_mlp: str = ""


class FusedWeights(NamedTuple):
    """What the fused backbones read: per stage, K5's pack of each block
    (pallas '1'), or K6's packs of the stage stacked (pallas 'stage'; None
    for a stage whose width no H admits, C % 128 != 0); and every block's
    LayerNorm fold, for the blocks the kernel's rule leaves out (which
    depends on H, so on the input)."""
    pallas: str
    stages: List[Union[List[FusedBlockWeights], Optional[FusedBlockWeights]]]
    ln_folds: List[List[LNFold]]


def block_kernel_applies(h: int) -> bool:
    """K5's rule (genconvit_tpu/models/convnext.py:194-195): a block of
    height H runs K5 when H >= 28 and H % 14 == 0."""
    return h >= 28 and h % 14 == 0


def stage_kernel_applies(h: int, c: int) -> bool:
    """K6's rule (convnext.py:452-454): a stage of height H and width C runs
    K6 when H >= 7 and C % 128 == 0."""
    return h >= 7 and c % 128 == 0


def backbone_path(x: torch.Tensor, plan: KernelPlan) -> str:
    """'kernels', 'mlp', '1', 'stage' or 'plain' (module docstring). The
    fused paths ignore plan.gelu for their kernels, as the JAX package's
    do."""
    if not (x.dtype == torch.bfloat16 and x.is_cuda) or plan.pallas == "0":
        return "plain"
    if plan.pallas in ("1", "stage"):
        return plan.pallas
    if plan.gelu == "exact":
        return "plain"
    return "kernels" if plan.mlp_stages() is None else "mlp"


class FeatureTensors(NamedTuple):
    """The tensors the features read (the head aside), in torch layout: the
    stem (conv weight, conv bias, LN scale, LN bias), per stage its
    downsample (LN scale, LN bias, conv weight, conv bias) or None, and
    its blocks. `flat` and `unflat` take it to and from the flat tuple an
    autograd Function takes."""
    stem: Tuple[torch.Tensor, ...]
    downsample: Tuple[Optional[Tuple[torch.Tensor, ...]], ...]
    blocks: Tuple[Tuple[BlockTensors, ...], ...]

    def layout(self) -> Tuple[Tuple[bool, int], ...]:
        return tuple((ds is not None, len(bl)) for ds, bl in zip(self.downsample, self.blocks))

    def flat(self) -> List[torch.Tensor]:
        out = list(self.stem)
        for ds, blocks in zip(self.downsample, self.blocks):
            out += list(ds or ())
            for t in blocks:
                out += list(t)
        return out

    @staticmethod
    def unflat(layout, tensors: Sequence[torch.Tensor]) -> "FeatureTensors":
        it = iter(tensors)
        stem = tuple(next(it) for _ in range(4))
        downsample, blocks = [], []
        for has_ds, n in layout:
            downsample.append(tuple(next(it) for _ in range(4)) if has_ds else None)
            blocks.append(tuple(BlockTensors(*(next(it) for _ in BlockTensors._fields))
                                for _ in range(n)))
        return FeatureTensors(stem, tuple(downsample), tuple(blocks))


@torch.no_grad()
def fold_tail(t: BlockTensors, int8_mlp: str = "") -> Union[FoldedMLP, FoldedMLPInt8]:
    """A block's tail folds, in f32 (matrices in the weights' dtype): K1's,
    or K4's of int8 mode 'fc1' or 'full'. No autograd graph: it would keep
    each fold's f32 intermediates alive."""
    if int8_mlp:
        return fold_block_mlp_int8(*tuple(t)[2:], int8_mlp, t.fc1_weight.dtype)
    return fold_block_mlp(*tuple(t)[2:], t.fc1_weight.dtype)


@torch.no_grad()
def kernel_weights(ft: FeatureTensors, int8_mlp: str = "") -> KernelWeights:
    """The kernel backbone's folds from `ft` (`fold_tail` for every block,
    the downsample LNs' parameters in f32)."""
    def f32(scale, bias):
        return scale.float().contiguous(), bias.float().contiguous()

    post_ln = [None if ds is None else f32(*ds[:2]) for ds in ft.downsample[1:]] + [None]
    blocks = [[fold_tail(t, int8_mlp) for t in stage] for stage in ft.blocks]
    return KernelWeights(stem_ln=f32(*ft.stem[2:]), blocks=blocks, post_ln=post_ln,
                         int8_mlp=int8_mlp)


def features_kernels(x: torch.Tensor, ft: FeatureTensors, kw: KernelWeights, gelu_tier: str,
                     tail: Callable, ln_rows: Callable,
                     seps: Optional[Sequence[Sequence[Optional[DwSep]]]] = None) -> torch.Tensor:
    """The kernel backbone (JAX _features_mlp_kernel, convnext.py:363-386):
    stem conv, `ln_rows` (K2) for the stem LN, per block the depthwise conv
    (separable where `seps` gives factors) then `tail` (K1 or K4) with the
    folds `kw`; the last block of a stage runs the next downsample's LN,
    whose conv then runs directly."""
    x = conv2d(x, ft.stem[0], ft.stem[1], stride=4)
    x = _nchw(ln_rows(_nhwc(x), *kw.stem_ln))
    for si, (ds, blocks) in enumerate(zip(ft.downsample, ft.blocks)):
        if ds is not None:
            # its LN already ran inside the previous stage's last K1
            x = conv2d(x, ds[2], ds[3], stride=2)
        last = len(blocks) - 1
        for bi, t in enumerate(blocks):
            d = depthwise(x, t, seps[si][bi] if seps else None)
            post = kw.post_ln[si] if bi == last else None
            x = _nchw(tail(_nhwc(d), _nhwc(x), kw.blocks[si][bi], post, gelu_tier))
    return x


def stage_mlp(x: torch.Tensor, blocks: Sequence[BlockTensors], folds: Sequence,
              gelu_tier: str, tail: Callable,
              seps: Optional[Sequence[Optional[DwSep]]] = None) -> torch.Tensor:
    """A chosen stage of the per-stage kernel path (JAX
    _apply_stage_mlp_kernel, convnext.py:276-303): per block the depthwise
    conv (separable where `seps` gives factors), then `tail` (K1 or K4)
    with the block's folds and no fused LayerNorm."""
    for bi, t in enumerate(blocks):
        d = depthwise(x, t, seps[bi] if seps else None)
        x = _nchw(tail(_nhwc(d), _nhwc(x), folds[bi], None, gelu_tier))
    return x


def features_reference(x: torch.Tensor, ft: FeatureTensors, gelu_tier: str) -> torch.Tensor:
    """The reference features graph (the JAX package's _features_mlp_bwd
    graph, convnext.py:413-430): plain stem conv and LN, plain downsample
    LN and conv, and the unfolded block (`block_reference`)."""
    x = conv2d(x, ft.stem[0], ft.stem[1], stride=4)
    x = layer_norm_2d(x, ft.stem[2], ft.stem[3], LN_EPS)
    for ds, blocks in zip(ft.downsample, ft.blocks):
        if ds is not None:
            x = conv2d(layer_norm_2d(x, ds[0], ds[1], LN_EPS), ds[2], ds[3], stride=2)
        for t in blocks:
            x = block_reference(x, t, gelu_tier)
    return x


def _reference_vjp(graph: Callable, x: torch.Tensor, tensors: Sequence[torch.Tensor],
                   g: torch.Tensor, needs: Sequence[bool]) -> tuple:
    """The gradients of graph(x, tensors) against cotangent g, by autograd
    of the graph recomputed from detached copies: None where not needed."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(needs[0])
        ts = [t.detach().requires_grad_(n) for t, n in zip(tensors, needs[1:])]
        out = graph(xs, ts)
        wanted = [v for v, n in zip([xs] + ts, needs) if n]
        got = iter(torch.autograd.grad(out, wanted, g, allow_unused=True) if wanted else ())
    return tuple(next(got) if n else None for n in needs)


class KernelBackbone(torch.autograd.Function):
    """The kernel backbone, differentiable (JAX _features_mlp_kernel with its
    custom VJP, convnext.py:350-433). Forward: `features_kernels` with folds
    made under no_grad from the tensors of the call (`kernel_weights`) on
    every call; backward: autograd of `features_reference` recomputed.
    `kernels` = (tail, ln_rows): the CUDA wrappers on the main path, their
    plain versions in the CPU tests."""

    @staticmethod
    def forward(ctx, layout, gelu_tier: str, int8_mlp: str, kernels, x, *tensors):
        ft = FeatureTensors.unflat(layout, tensors)
        out = features_kernels(x, ft, kernel_weights(ft, int8_mlp), gelu_tier, *kernels)
        ctx.save_for_backward(x, *tensors)
        ctx.layout, ctx.gelu_tier = layout, gelu_tier
        return out

    @staticmethod
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        layout, tier = ctx.layout, ctx.gelu_tier
        grads = _reference_vjp(
            lambda v, ts: features_reference(v, FeatureTensors.unflat(layout, ts), tier),
            x, tensors, g, ctx.needs_input_grad[4:])
        return (None, None, None, None) + grads


class FusedBlock(torch.autograd.Function):
    """One block through a fused-block kernel, differentiable (JAX
    _block_pallas_op, convnext.py:160-179). Forward: `kernel` (K5, or its
    plain version) on the block packed from the tensors of the call;
    backward: autograd of `block_reference` recomputed."""

    @staticmethod
    def forward(ctx, gelu_tier: str, kernel, x, *tensors):
        t = BlockTensors(*tensors)
        out = _nchw(kernel(_nhwc(x), pack_block(*t, t.fc1_weight.dtype)))
        ctx.save_for_backward(x, *tensors)
        ctx.gelu_tier = gelu_tier
        return out

    @staticmethod
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        tier = ctx.gelu_tier
        grads = _reference_vjp(lambda v, ts: block_reference(v, BlockTensors(*ts), tier),
                               x, tensors, g, ctx.needs_input_grad[2:])
        return (None, None) + grads


def _chain(tensors: Sequence[torch.Tensor]) -> List[BlockTensors]:
    k = len(BlockTensors._fields)
    return [BlockTensors(*tensors[i:i + k]) for i in range(0, len(tensors), k)]


class FusedStage(torch.autograd.Function):
    """A stage's chain of blocks through a fused-stage kernel, differentiable
    (JAX _stage_pallas_op, convnext.py:201-227). Forward: `kernel` (K6, or
    its plain version) on the chain packed and stacked from the tensors of
    the call; backward: autograd of the chain of `block_reference`s
    recomputed."""

    @staticmethod
    def forward(ctx, gelu_tier: str, kernel, x, *tensors):
        packs = [pack_block(*t, t.fc1_weight.dtype) for t in _chain(tensors)]
        out = _nchw(kernel(_nhwc(x), stack_blocks(packs)))
        ctx.save_for_backward(x, *tensors)
        ctx.gelu_tier = gelu_tier
        return out

    @staticmethod
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        tier = ctx.gelu_tier

        def chain(v, ts):
            for t in _chain(ts):
                v = block_reference(v, t, tier)
            return v

        grads = _reference_vjp(chain, x, tensors, g, ctx.needs_input_grad[2:])
        return (None, None) + grads


class MlpStage(FusedStage):
    """A chosen stage of the per-stage kernel path, differentiable (JAX
    _apply_stage_mlp_kernel with its custom VJP, convnext.py:276-322).
    Forward: `stage_mlp` with `kernel` = (tail, int8_mlp), the tails folded
    (`fold_tail`) from the tensors of the call; backward: FusedStage's,
    autograd of the chain of `block_reference`s recomputed."""

    @staticmethod
    def forward(ctx, gelu_tier: str, kernel, x, *tensors):
        tail, int8_mlp = kernel
        chain = _chain(tensors)
        out = stage_mlp(x, chain, [fold_tail(t, int8_mlp) for t in chain], gelu_tier, tail)
        ctx.save_for_backward(x, *tensors)
        ctx.gelu_tier = gelu_tier
        return out


class ConvNeXt(nn.Module):
    def __init__(self, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 num_classes: int = 1000):
        super().__init__()
        self.stem = nn.Sequential(nn.Conv2d(3, dims[0], 4, stride=4),
                                  LayerNorm2d(dims[0]))
        in_dims = (dims[0],) + tuple(dims[:-1])
        self.stages = nn.ModuleList(
            Stage(i, d, n, si > 0)
            for si, (i, d, n) in enumerate(zip(in_dims, dims, depths)))
        self.head = nn.Module()
        self.head.norm = nn.LayerNorm(dims[-1], eps=LN_EPS)
        self.head.fc = nn.Linear(dims[-1], num_classes)
        self._kernel_weights: Optional[KernelWeights] = None
        self._fused_weights: Optional[FusedWeights] = None

    @classmethod
    def from_name(cls, name: str, num_classes: int = 1000) -> "ConvNeXt":
        return cls(num_classes=num_classes, **CONVNEXT_CFGS[name])

    def feature_tensors(self) -> FeatureTensors:
        """The features' tensors as the module holds them now (under
        torch.func.functional_call, the ones substituted)."""
        stem = (self.stem[0].weight, self.stem[0].bias, self.stem[1].weight, self.stem[1].bias)
        downsample = tuple(
            None if st.downsample is None else
            (st.downsample[0].weight, st.downsample[0].bias, st.downsample[1].weight,
             st.downsample[1].bias) for st in self.stages)
        blocks = tuple(tuple(blk.tensors() for blk in st.blocks) for st in self.stages)
        return FeatureTensors(stem, downsample, blocks)

    def fold_kernel_weights(self, int8_mlp: str = "") -> KernelWeights:
        """The kernel backbone's folds from the module's current weights
        (`kernel_weights`)."""
        return kernel_weights(self.feature_tensors(), int8_mlp)

    @torch.no_grad()
    def pack_fused_weights(self, pallas: str) -> FusedWeights:
        """The fused backbones' packs from the module's current weights:
        K5's for every block (pallas '1': the rule depends on H, which the
        input sets), K6's stacked for every stage of a width K6 takes, and
        every block's LayerNorm fold."""
        ln_folds = [[blk.fold_ln() for blk in stage.blocks] for stage in self.stages]
        if pallas == "1":
            return FusedWeights("1", [[blk.pack_fused() for blk in stage.blocks]
                                      for stage in self.stages], ln_folds)
        stages = []
        for stage in self.stages:
            c = stage.blocks[0].gamma.shape[0]
            stages.append(stack_blocks([blk.pack_fused() for blk in stage.blocks])
                          if c % 128 == 0 else None)
        return FusedWeights("stage", stages, ln_folds)

    def prepare_kernels(self, plan: KernelPlan = DEFAULT_PLAN) -> None:
        """Fold or pack once for the plan's kernel backbone, after the final
        dtype cast: K1's or K4's folds (pallas ''), K5's or K6's packs and
        the LayerNorm folds of the blocks around them (pallas '1' or
        'stage'). The kernel paths read only these: call it
        again after any change to the weights. Blocks with separable
        depthwise factors refuse '1' and 'stage', whose kernels convolve
        the exact weights."""
        if plan.pallas in ("1", "stage"):
            if any(sep is not None for stage in self.dw_seps() for sep in stage):
                raise ValueError(f"pallas={plan.pallas!r} convolves the exact depthwise "
                                 f"weights: it cannot run blocks with separable factors "
                                 f"(dw_rank)")
            self._kernel_weights = None
            self._fused_weights = self.pack_fused_weights(plan.pallas)
        else:
            self._fused_weights = None
            self._kernel_weights = self.fold_kernel_weights(plan.int8_mlp)

    def dw_seps(self) -> List[List[Optional[DwSep]]]:
        """Each block's separable depthwise factors (None where it has
        none), by stage."""
        return [[blk.dw_sep for blk in stage.blocks] for stage in self.stages]

    def _blocks_plain(self, stage: Stage, x: torch.Tensor, gelu_tier: str) -> torch.Tensor:
        """A stage's blocks on the plain path: the LN-folded block, folded
        per call, in bfloat16; the reference block otherwise."""
        for blk in stage.blocks:
            if x.dtype == torch.bfloat16:
                x = blk.forward_folded(x, gelu_tier, blk.fold_ln())
            else:
                x = blk(x, gelu_tier)
        return x

    def _features_plain(self, x: torch.Tensor, gelu_tier: str) -> torch.Tensor:
        x = self._stem_plain(x)
        for stage in self.stages:
            x = self._blocks_plain(stage, self._downsample_plain(stage, x), gelu_tier)
        return x

    def _fused(self, pallas: str) -> FusedWeights:
        fw = self._fused_weights
        if fw is None or fw.pallas != pallas:
            raise RuntimeError(
                f"fused backbone pallas={pallas!r} without its packs: call "
                f"prepare_kernels(plan) with this plan")
        return fw

    def _stem_plain(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(x, self.stem[0].weight, self.stem[0].bias, stride=4)
        return self.stem[1](x)

    def _downsample_plain(self, stage: Stage, x: torch.Tensor) -> torch.Tensor:
        if stage.downsample is None:
            return x
        ln, conv = stage.downsample
        return conv2d(ln(x), conv.weight, conv.bias, stride=2)

    def _features_block(self, x: torch.Tensor, gelu_tier: str,
                        per_call: bool = False) -> torch.Tensor:
        """The fused-block backbone (pallas '1'): K5 where
        block_kernel_applies(H), the LN-folded block (plan's GELU)
        elsewhere. Serving reads prepare_kernels's packs and folds; training
        packs per call (`FusedBlock`) and folds per call with a graph
        (`Block.fold_ln`)."""
        fw = None if per_call else self._fused("1")
        x = self._stem_plain(x)
        for si, stage in enumerate(self.stages):
            x = self._downsample_plain(stage, x)
            for bi, blk in enumerate(stage.blocks):
                if block_kernel_applies(x.shape[2]):
                    if per_call:
                        x = FusedBlock.apply(gelu_tier, fused_convnext_block, x,
                                             *blk.tensors())
                    else:
                        x = _nchw(fused_convnext_block(_nhwc(x), fw.stages[si][bi]))
                else:
                    fold = blk.fold_ln() if per_call else fw.ln_folds[si][bi]
                    x = blk.forward_folded(x, gelu_tier, fold)
        return x

    def _features_stage(self, x: torch.Tensor, gelu_tier: str,
                        per_call: bool = False) -> torch.Tensor:
        """The fused-stage backbone (pallas 'stage'): K6 on a stage where
        stage_kernel_applies(H, C), the LN-folded blocks elsewhere; per call
        in training (`FusedStage`, `Block.fold_ln`)."""
        fw = None if per_call else self._fused("stage")
        x = self._stem_plain(x)
        for si, stage in enumerate(self.stages):
            x = self._downsample_plain(stage, x)
            if stage_kernel_applies(x.shape[2], x.shape[1]):
                if per_call:
                    x = FusedStage.apply(gelu_tier, fused_convnext_stage, x,
                                         *(t for blk in stage.blocks for t in blk.tensors()))
                else:
                    x = _nchw(fused_convnext_stage(_nhwc(x), fw.stages[si]))
            else:
                for bi, blk in enumerate(stage.blocks):
                    fold = blk.fold_ln() if per_call else fw.ln_folds[si][bi]
                    x = blk.forward_folded(x, gelu_tier, fold)
        return x

    def _folds(self, int8_mlp: str) -> KernelWeights:
        kw = self._kernel_weights
        if kw is None:
            raise RuntimeError("kernel backbone without folds: call prepare_kernels() first")
        if kw.int8_mlp != int8_mlp:
            raise RuntimeError(
                f"kernel backbone folded for int8_mlp={kw.int8_mlp!r}, run with "
                f"{int8_mlp!r}: call prepare_kernels(plan) with this plan")
        return kw

    def _features_kernels(self, x: torch.Tensor, gelu_tier: str,
                          int8_mlp: str = "") -> torch.Tensor:
        kw = self._folds(int8_mlp)
        tail = ln_mlp_residual_int8 if int8_mlp else ln_mlp_residual
        return features_kernels(x, self.feature_tensors(), kw, gelu_tier, tail, layer_norm_rows,
                                self.dw_seps())

    def _features_mlp(self, x: torch.Tensor, gelu_tier: str, stages: AbstractSet[int],
                      int8_mlp: str = "", per_call: bool = False) -> torch.Tensor:
        """The per-stage kernel path (pallas 'mlp...'): plain stem and
        downsample LNs, `stage_mlp` on the chosen stages with K1 (or K4)
        (folds of prepare_kernels; in training `MlpStage`, folds per call),
        the LN-folded block elsewhere."""
        tail = ln_mlp_residual_int8 if int8_mlp else ln_mlp_residual
        kw = None if per_call else self._folds(int8_mlp)
        x = self._stem_plain(x)
        for si, stage in enumerate(self.stages):
            x = self._downsample_plain(stage, x)
            if si not in stages:
                x = self._blocks_plain(stage, x, gelu_tier)
            elif per_call:
                x = MlpStage.apply(gelu_tier, (tail, int8_mlp), x,
                                   *(t for blk in stage.blocks for t in blk.tensors()))
            else:
                x = stage_mlp(x, [blk.tensors() for blk in stage.blocks], kw.blocks[si],
                              gelu_tier, tail, [blk.dw_sep for blk in stage.blocks])
        return x

    def features(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN,
                 per_call_folds: bool = False) -> torch.Tensor:
        """[N,3,H,W] -> [N,C,H/32,W/32] (pre-head). per_call_folds: the
        kernel paths fold or pack from the module's tensors on every call
        and are differentiable (training; module docstring); otherwise they
        read prepare_kernels's folds."""
        path = backbone_path(x, plan)
        if path == "kernels":
            if per_call_folds:
                ft = self.feature_tensors()
                tail = ln_mlp_residual_int8 if plan.int8_mlp else ln_mlp_residual
                return KernelBackbone.apply(ft.layout(), plan.gelu, plan.int8_mlp,
                                            (tail, layer_norm_rows), x, *ft.flat())
            return self._features_kernels(x, plan.gelu, plan.int8_mlp)
        if path == "mlp":
            return self._features_mlp(x, plan.gelu, plan.mlp_stages(), plan.int8_mlp,
                                      per_call_folds)
        if path == "1":
            return self._features_block(x, plan.gelu, per_call_folds)
        if path == "stage":
            return self._features_stage(x, plan.gelu, per_call_folds)
        return self._features_plain(x, plan.gelu)

    def forward(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN,
                per_call_folds: bool = False) -> torch.Tensor:
        x = self.features(x, plan, per_call_folds).mean(dim=(2, 3))
        x = layer_norm(x, self.head.norm.weight, self.head.norm.bias, LN_EPS)
        return F.linear(x, self.head.fc.weight, self.head.fc.bias)
