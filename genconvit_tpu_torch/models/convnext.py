"""ConvNeXt backbone (port of genconvit_tpu/models/convnext.py).

timm 0.6.5 `convnext_*` as the reference consumes it: stem (4x4/4 conv +
LN), four stages of [LN + 2x2/2 downsample (stages 1-3); blocks of
depthwise 7x7 -> LN -> MLP(4x, GELU) -> layer scale -> residual], head
(global mean -> LN -> fc). Parameter names are timm's.

Four paths, chosen per call as the JAX package chooses them
(convnext.py:182-198, 436-495); the first three need bfloat16 on CUDA:

  * kernel backbone — plan.pallas '' and plan.gelu != 'exact': stem conv ->
    K2 (the stem LN as `layer_norm_rows`); per block the depthwise conv,
    then K1 (`ln_mlp_residual`) on the NHWC rows, or K4
    (`ln_mlp_residual_int8`) when plan.int8_mlp is 'fc1' or 'full'. The last
    block of stages 0-2 fuses the next downsample's LN (`post_ln`), and the
    downsample then runs its conv directly;
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

Activations are NCHW in channels_last memory, so the NHWC view the kernels
read as [N*H*W, C] rows is the tensor's own storage.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

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
    the upcast product elsewhere. The same numbers up to summation order: a
    bf16 product is exact in float32."""
    if d.is_cuda and d.dtype == torch.bfloat16:
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


class Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def dw(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.conv_dw.weight, self.conv_dw.bias, padding=3,
                      groups=x.shape[1])

    def forward(self, x: torch.Tensor, gelu_tier: str = "default") -> torch.Tensor:
        """The plain block (genconvit_tpu/models/convnext.py:106-115)."""
        h = _nhwc(self.dw(x))
        h = layer_norm(h, self.norm.weight, self.norm.bias, LN_EPS)
        h = F.linear(h, self.mlp.fc1.weight, self.mlp.fc1.bias)
        h = gelu(h, gelu_tier)
        h = F.linear(h, self.mlp.fc2.weight, self.mlp.fc2.bias)
        h = h * self.gamma.to(h.dtype)
        return x + _nchw(h)

    def forward_folded(self, x: torch.Tensor, gelu_tier: str, fold: LNFold) -> torch.Tensor:
        """The block with its LayerNorm folded into fc1, as the JAX package
        runs a bf16 block outside its kernels (_block_xla_folded,
        convnext.py:118-157): one-pass f32 moments of the depthwise output
        d, z = d . wg in f32, y = ((z - mean * gw) * rsqrt(var + eps) + bw)
        in the activations' dtype, then GELU, fc2 and the layer scale in it."""
        d = _nhwc(self.dw(x))
        mean, inv = _row_moments(d.float())
        z = f32_product(d, fold.wg)
        h = ((z - mean * fold.gw) * inv + fold.bw).to(x.dtype)
        h = gelu(h, gelu_tier)
        h = F.linear(h, self.mlp.fc2.weight, self.mlp.fc2.bias)
        h = h * self.gamma.to(h.dtype)
        return x + _nchw(h)

    def fold_ln(self) -> LNFold:
        """The LayerNorm fold of forward_folded, in f32 from the current
        weights; wg in the weights' dtype. Differentiable, as the JAX
        package's fold inside the block; prepare_kernels stores it without
        a graph."""
        w1 = self.mlp.fc1.weight.float().t()
        s = self.norm.weight.float()
        return LNFold(wg=(s[:, None] * w1).to(self.mlp.fc1.weight.dtype).contiguous(),
                      gw=(s @ w1).contiguous(),
                      bw=(self.norm.bias.float() @ w1 + self.mlp.fc1.bias.float()).contiguous())

    def _fold_args(self):
        return (self.norm.weight, self.norm.bias, self.mlp.fc1.weight,
                self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
                self.gamma)

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
        return pack_block(self.conv_dw.weight, self.conv_dw.bias, self.norm.weight,
                          self.norm.bias, self.mlp.fc1.weight, self.mlp.fc1.bias,
                          self.mlp.fc2.weight, self.mlp.fc2.bias, self.gamma,
                          self.mlp.fc1.weight.dtype)


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
    """'kernels', '1', 'stage' or 'plain' (module docstring). The fused
    paths ignore plan.gelu for their kernels, as the JAX package's do."""
    if not (x.dtype == torch.bfloat16 and x.is_cuda) or plan.pallas == "0":
        return "plain"
    if plan.pallas in ("1", "stage"):
        return plan.pallas
    return "kernels" if plan.gelu != "exact" else "plain"


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

    @torch.no_grad()
    def fold_kernel_weights(self, int8_mlp: str = "") -> KernelWeights:
        """The kernel backbone's folds, computed in f32 from the module's
        current weights: K1's, or K4's of int8 mode 'fc1' or 'full'. No
        autograd graph: it would keep each fold's f32 intermediates alive."""
        def f32(ln):
            return ln.weight.float().contiguous(), ln.bias.float().contiguous()

        post_ln = [f32(nxt.downsample[0]) if nxt.downsample is not None else None
                   for nxt in list(self.stages)[1:]] + [None]
        return KernelWeights(
            stem_ln=f32(self.stem[1]),
            blocks=[[blk.fold_int8(int8_mlp) if int8_mlp else blk.fold()
                     for blk in stage.blocks] for stage in self.stages],
            post_ln=post_ln, int8_mlp=int8_mlp)

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
        again after any change to the weights."""
        if plan.pallas in ("1", "stage"):
            self._kernel_weights = None
            self._fused_weights = self.pack_fused_weights(plan.pallas)
        else:
            self._fused_weights = None
            self._kernel_weights = self.fold_kernel_weights(plan.int8_mlp)

    def _features_plain(self, x: torch.Tensor, gelu_tier: str) -> torch.Tensor:
        x = self._stem_plain(x)
        for stage in self.stages:
            x = self._downsample_plain(stage, x)
            for blk in stage.blocks:
                if x.dtype == torch.bfloat16:
                    x = blk.forward_folded(x, gelu_tier, blk.fold_ln())
                else:
                    x = blk(x, gelu_tier)
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

    def _features_block(self, x: torch.Tensor, gelu_tier: str) -> torch.Tensor:
        """The fused-block backbone (pallas '1'): K5 where
        block_kernel_applies(H), the LN-folded block (plan's GELU)
        elsewhere."""
        fw = self._fused("1")
        x = self._stem_plain(x)
        for si, stage in enumerate(self.stages):
            x = self._downsample_plain(stage, x)
            for bi, blk in enumerate(stage.blocks):
                if block_kernel_applies(x.shape[2]):
                    x = _nchw(fused_convnext_block(_nhwc(x), fw.stages[si][bi]))
                else:
                    x = blk.forward_folded(x, gelu_tier, fw.ln_folds[si][bi])
        return x

    def _features_stage(self, x: torch.Tensor, gelu_tier: str) -> torch.Tensor:
        """The fused-stage backbone (pallas 'stage'): K6 on a stage where
        stage_kernel_applies(H, C), the LN-folded blocks elsewhere."""
        fw = self._fused("stage")
        x = self._stem_plain(x)
        for si, stage in enumerate(self.stages):
            x = self._downsample_plain(stage, x)
            if stage_kernel_applies(x.shape[2], x.shape[1]):
                x = _nchw(fused_convnext_stage(_nhwc(x), fw.stages[si]))
            else:
                for bi, blk in enumerate(stage.blocks):
                    x = blk.forward_folded(x, gelu_tier, fw.ln_folds[si][bi])
        return x

    def _features_kernels(self, x: torch.Tensor, gelu_tier: str,
                          int8_mlp: str = "") -> torch.Tensor:
        kw = self._kernel_weights
        if kw is None:
            raise RuntimeError("kernel backbone without folds: call prepare_kernels() first")
        if kw.int8_mlp != int8_mlp:
            raise RuntimeError(
                f"kernel backbone folded for int8_mlp={kw.int8_mlp!r}, run with "
                f"{int8_mlp!r}: call prepare_kernels(plan) with this plan")
        tail = ln_mlp_residual_int8 if int8_mlp else ln_mlp_residual
        x = conv2d(x, self.stem[0].weight, self.stem[0].bias, stride=4)
        x = _nchw(layer_norm_rows(_nhwc(x), *kw.stem_ln))
        for si, stage in enumerate(self.stages):
            if stage.downsample is not None:
                # its LN already ran inside the previous stage's last K1
                conv = stage.downsample[1]
                x = conv2d(x, conv.weight, conv.bias, stride=2)
            last = len(stage.blocks) - 1
            for bi, blk in enumerate(stage.blocks):
                d = blk.dw(x)
                post = kw.post_ln[si] if bi == last else None
                x = _nchw(tail(_nhwc(d), _nhwc(x), kw.blocks[si][bi], post,
                               gelu_tier))
        return x

    def features(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN) -> torch.Tensor:
        """[N,3,H,W] -> [N,C,H/32,W/32] (pre-head)."""
        path = backbone_path(x, plan)
        if path == "kernels":
            return self._features_kernels(x, plan.gelu, plan.int8_mlp)
        if path == "1":
            return self._features_block(x, plan.gelu)
        if path == "stage":
            return self._features_stage(x, plan.gelu)
        return self._features_plain(x, plan.gelu)

    def forward(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN) -> torch.Tensor:
        x = self.features(x, plan).mean(dim=(2, 3))
        x = layer_norm(x, self.head.norm.weight, self.head.norm.bias, LN_EPS)
        return F.linear(x, self.head.fc.weight, self.head.fc.bias)
