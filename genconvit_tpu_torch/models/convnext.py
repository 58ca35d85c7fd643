"""ConvNeXt backbone (port of genconvit_tpu/models/convnext.py).

timm 0.6.5 `convnext_*` as the reference consumes it: stem (4x4/4 conv +
LN), four stages of [LN + 2x2/2 downsample (stages 1-3); blocks of
depthwise 7x7 -> LN -> MLP(4x, GELU) -> layer scale -> residual], head
(global mean -> LN -> fc). Parameter names are timm's.

Two paths, chosen per call as the JAX package chooses them
(convnext.py:478-495):

  * kernel backbone — bfloat16 on CUDA, plan.gelu != 'exact' and
    plan.pallas != '0': stem conv -> K2 (the stem LN as `layer_norm_rows`);
    per block the depthwise conv, then K1 (`ln_mlp_residual`) on the NHWC
    rows. The last block of stages 0-2 fuses the next downsample's LN
    (`post_ln`), and the downsample then runs its conv directly;
  * plain graph — everything else (float32, CPU, pallas '0', exact GELU):
    the reference block with two-pass LayerNorm and the plan's GELU.

Activations are NCHW in channels_last memory, so the NHWC view the kernels
read as [N*H*W, C] rows is the tensor's own storage.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from genconvit_tpu_torch.ops.act import gelu
from genconvit_tpu_torch.ops.conv import conv2d
from genconvit_tpu_torch.ops.cuda.convnext_mlp import (FoldedMLP,
                                                       fold_block_mlp,
                                                       layer_norm_rows,
                                                       ln_mlp_residual)
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

    def fold(self) -> FoldedMLP:
        """The MLP folds, matrices in the weights' dtype (bf16 on the
        kernel path)."""
        return fold_block_mlp(self.norm.weight, self.norm.bias,
                              self.mlp.fc1.weight, self.mlp.fc1.bias,
                              self.mlp.fc2.weight, self.mlp.fc2.bias,
                              self.gamma, self.mlp.fc1.weight.dtype)


class Stage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, downsample: bool):
        super().__init__()
        self.downsample = (nn.Sequential(LayerNorm2d(in_dim),
                                         nn.Conv2d(in_dim, dim, 2, stride=2))
                           if downsample else None)
        self.blocks = nn.Sequential(*[Block(dim) for _ in range(depth)])


class KernelWeights(NamedTuple):
    """What the kernel backbone reads besides the module's own weights:
    f32 LayerNorm params and each block's folded MLP."""
    stem_ln: Tuple[torch.Tensor, torch.Tensor]
    blocks: List[List[FoldedMLP]]
    post_ln: List[Optional[Tuple[torch.Tensor, torch.Tensor]]]


def uses_kernels(x: torch.Tensor, plan: KernelPlan) -> bool:
    return (x.dtype == torch.bfloat16 and x.is_cuda
            and plan.gelu != "exact" and plan.pallas != "0")


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

    @classmethod
    def from_name(cls, name: str, num_classes: int = 1000) -> "ConvNeXt":
        return cls(num_classes=num_classes, **CONVNEXT_CFGS[name])

    def fold_kernel_weights(self) -> KernelWeights:
        """The kernel backbone's folds, computed in f32 from the module's
        current weights."""
        def f32(ln):
            return ln.weight.float().contiguous(), ln.bias.float().contiguous()

        post_ln = [f32(nxt.downsample[0]) if nxt.downsample is not None else None
                   for nxt in list(self.stages)[1:]] + [None]
        return KernelWeights(
            stem_ln=f32(self.stem[1]),
            blocks=[[blk.fold() for blk in stage.blocks] for stage in self.stages],
            post_ln=post_ln)

    def prepare_kernels(self) -> None:
        """Fold once for the kernel backbone, after the final dtype cast.
        The kernel path reads only these folds: call it again after any
        change to the weights."""
        self._kernel_weights = self.fold_kernel_weights()

    def _features_plain(self, x: torch.Tensor, gelu_tier: str) -> torch.Tensor:
        x = conv2d(x, self.stem[0].weight, self.stem[0].bias, stride=4)
        x = self.stem[1](x)
        for stage in self.stages:
            if stage.downsample is not None:
                ln, conv = stage.downsample
                x = conv2d(ln(x), conv.weight, conv.bias, stride=2)
            for blk in stage.blocks:
                x = blk(x, gelu_tier)
        return x

    def _features_kernels(self, x: torch.Tensor, gelu_tier: str) -> torch.Tensor:
        kw = self._kernel_weights
        if kw is None:
            raise RuntimeError("kernel backbone without folds: call prepare_kernels() first")
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
                x = _nchw(ln_mlp_residual(_nhwc(d), _nhwc(x), kw.blocks[si][bi],
                                          post, gelu_tier))
        return x

    def features(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN) -> torch.Tensor:
        """[N,3,H,W] -> [N,C,H/32,W/32] (pre-head)."""
        if uses_kernels(x, plan):
            return self._features_kernels(x, plan.gelu)
        return self._features_plain(x, plan.gelu)

    def forward(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN) -> torch.Tensor:
        x = self.features(x, plan).mean(dim=(2, 3))
        x = layer_norm(x, self.head.norm.weight, self.head.norm.bias, LN_EPS)
        return F.linear(x, self.head.fc.weight, self.head.fc.bias)
