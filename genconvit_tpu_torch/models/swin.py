"""Swin Transformer (port of genconvit_tpu/models/swin.py).

timm 0.6.5 `swin_*_patch4_window7_224`, the reference's "embedder": a 4x4/4
patch conv + LN, stages of Swin blocks (LN -> windowed multi-head attention
with a relative position bias, in shifted windows every other block -> LN ->
MLP(4x, GELU), each with a residual), patch merging between stages, a final
LN; `forward` adds the mean token pool and the head. Parameter names are
timm's, the keys the JAX package's `convert_swin` reads; the relative
position index and the shift mask are recomputed, never in the state dict.

The attention takes one of two paths per call (`window_kernel_applies`):

  * K7 (`ops/cuda/window_attn.window_attention`) on a CUDA bfloat16 model
    unless plan.pallas is '0' (for '', '1' and 'stage' alike, as the JAX
    package enables its Pallas kernel for every value but '0' on the TPU);
  * the JAX package's XLA graph (swin.py:170-179) everywhere else: float32,
    every CPU tensor, pallas '0'. It scales q in the activations' dtype and
    casts the softmax to it, where K7 scales in float32: the two bf16 graphs
    round differently and are kept apart.

Activations are tokens [N, H*W, C]; the input is an NCHW image batch.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from genconvit_tpu_torch.models.convnext import Mlp
from genconvit_tpu_torch.ops.act import gelu
from genconvit_tpu_torch.ops.conv import conv2d
from genconvit_tpu_torch.ops.cuda.window_attn import window_attention
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
from genconvit_tpu_torch.ops.norm import layer_norm

SWIN_CFGS: Dict[str, Dict[str, Any]] = {
    "swin_tiny_patch4_window7_224": dict(
        embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window=7),
    "swin_small_patch4_window7_224": dict(
        embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), window=7),
    "swin_base_patch4_window7_224": dict(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=7),
    "swin_large_patch4_window7_224": dict(
        embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), window=7),
}

LN_EPS = 1e-5   # torch nn.LayerNorm's default, which Swin uses
DEFAULT_PLAN = KernelPlan()


@functools.lru_cache(maxsize=32)
def relative_position_index(window: int, table_window: Optional[int] = None) -> np.ndarray:
    """The [w*w, w*w] int32 index into the (2*tw-1)^2-row bias table; for a
    window clamped below the table's (tw > window) it indexes the table's
    centered entries."""
    tw = table_window or window
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (tw - 1)
    return (rel[..., 0] * (2 * tw - 1) + rel[..., 1]).astype(np.int32)


@functools.lru_cache(maxsize=64)
def shifted_window_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """The [nW, L, L] float32 mask (0 or -100) of shifted windows on an h x w
    grid rolled by -shift; windows in row-major order."""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _index_on(window: int, table_window: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        relative_position_index(window, table_window).reshape(-1).astype(np.int64)).to(device)


@functools.lru_cache(maxsize=64)
def _mask_on(h: int, w: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(shifted_window_mask(h, w, window, shift)).to(device)


def block_window(hw: Tuple[int, int], window: int, bi: int) -> Tuple[int, int]:
    """(window, shift) of block bi on an hw grid (swin.py:245-254): the
    window clamped to min(hw); shift 0 for even blocks and whenever
    min(hw) <= window, else half the clamped window."""
    eff = min(window, min(hw))
    return eff, 0 if (bi % 2 == 0 or min(hw) <= window) else eff // 2


def window_kernel_applies(x: torch.Tensor, plan: KernelPlan) -> bool:
    """K7's rule (module docstring)."""
    return x.is_cuda and x.dtype == torch.bfloat16 and plan.pallas != "0"


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[N, H, W, C] -> [N * nW, window^2, C], windows row-major."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(win: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """[N * nW, window^2, C] -> [N, H, W, C]."""
    n = win.shape[0] // ((h // window) * (w // window))
    x = win.reshape(n, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, -1)


def _scores_f32(q: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """q [..., L, hd] . kt [..., hd, L] with a float32 result (JAX's
    preferred_element_type=float32): the bf16 product with an f32 result on
    CUDA, the upcast product elsewhere; the same up to summation order."""
    if q.is_cuda and q.dtype == torch.bfloat16:
        lead = q.shape[:-2]
        s = torch.bmm(q.reshape((-1,) + q.shape[-2:]), kt.reshape((-1,) + kt.shape[-2:]),
                      out_dtype=torch.float32)
        return s.view(lead + s.shape[-2:])
    return q.float() @ kt.float()


def attention_xla(qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                  heads: int) -> torch.Tensor:
    """The JAX package's XLA attention graph (swin.py:170-179) on qkv
    [B, L, 3C] -> [B, L, C]: q scaled in qkv's dtype, f32 scores + bias
    (+ the mask of window b % nW, B a multiple of nW), softmax in f32 cast
    to qkv's dtype, p . v in that dtype."""
    b, l, c3 = qkv.shape
    hd = c3 // (3 * heads)
    q, k, v = qkv.view(b, l, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    q = q * torch.tensor(hd ** -0.5, dtype=q.dtype)
    attn = _scores_f32(q, k.transpose(-1, -2)) + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b // nw, nw, heads, l, l) + mask[:, None].float()).view(b, heads, l, l)
    p = torch.softmax(attn, dim=-1).to(qkv.dtype)
    return (p @ v).transpose(1, 2).reshape(b, l, c3 // 3)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))

    def position_bias(self, window: int) -> torch.Tensor:
        """[heads, L, L] in the table's dtype; the table's own window is
        recovered from its row count (swin.py:149-153)."""
        table = self.relative_position_bias_table
        tw = (int(round(table.shape[0] ** 0.5)) + 1) // 2
        l = window * window
        bias = table[_index_on(window, tw, table.device)]
        return bias.view(l, l, self.heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, window: int, mask: Optional[torch.Tensor],
                kernel: bool) -> torch.Tensor:
        """x [B, L, C] windows -> [B, L, C]; K7 when `kernel`."""
        qkv = F.linear(x, self.qkv.weight, self.qkv.bias)
        bias = self.position_bias(window)
        if kernel:
            out = window_attention(qkv, bias.float().contiguous(), mask, self.heads,
                                   1 if mask is None else mask.shape[0])
        else:
            out = attention_xla(qkv, bias, mask, self.heads)
        return F.linear(out, self.proj.weight, self.proj.bias)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int], window: int, shift: int,
                gelu_tier: str, kernel: bool) -> torch.Tensor:
        """swin.py:182-205: x [N, H*W, C]; the roll is (-shift, -shift)
        before the attention and (+shift, +shift) after."""
        h, w = hw
        n, l, c = x.shape
        y = layer_norm(x, self.norm1.weight, self.norm1.bias, LN_EPS).view(n, h, w, c)
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _mask_on(h, w, window, shift, x.device)
        y = self.attn(window_partition(y, window), window, mask, kernel)
        y = window_reverse(y, window, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y.reshape(n, l, c)
        z = layer_norm(x, self.norm2.weight, self.norm2.bias, LN_EPS)
        z = gelu(F.linear(z, self.mlp.fc1.weight, self.mlp.fc1.bias), gelu_tier)
        return x + F.linear(z, self.mlp.fc2.weight, self.mlp.fc2.bias)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]):
        """[N, H*W, C] -> ([N, H*W/4, 2C], (H/2, W/2)) (swin.py:208-222)."""
        h, w = hw
        if h % 2 or w % 2:
            raise ValueError(f"swin patch merging needs an even grid, got {h}x{w}")
        n, _, c = x.shape
        x = x.view(n, h, w, c)
        # torch cat order: [0::2, 0::2], [1::2, 0::2], [0::2, 1::2], [1::2, 1::2]
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).view(n, (h // 2) * (w // 2), 4 * c)
        x = layer_norm(x, self.norm.weight, self.norm.bias, LN_EPS)
        return F.linear(x, self.reduction.weight), (h // 2, w // 2)


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, window) for _ in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class SwinTransformer(nn.Module):
    """cfg: a SWIN_CFGS name or a dict of embed_dim, depths, num_heads and
    window."""

    def __init__(self, cfg: Union[str, Dict[str, Any]] = "swin_tiny_patch4_window7_224",
                 num_classes: int = 1000):
        super().__init__()
        self.cfg = dict(SWIN_CFGS[cfg] if isinstance(cfg, str) else cfg)
        dim, depths = self.cfg["embed_dim"], self.cfg["depths"]
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, 4, stride=4)
        self.patch_embed.norm = nn.LayerNorm(dim, eps=LN_EPS)
        layers = []
        for li, depth in enumerate(depths):
            last = li == len(depths) - 1
            layers.append(SwinStage(dim, depth, self.cfg["num_heads"][li],
                                    self.cfg["window"], not last))
            dim = dim if last else 2 * dim
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, num_classes)

    @property
    def width(self) -> int:
        """The final token width."""
        return self.norm.weight.shape[0]

    def features(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN) -> torch.Tensor:
        """[N, 3, H, W] -> [N, L, C] final token features (after the final
        LN) (swin.py:225-257)."""
        x = conv2d(x, self.patch_embed.proj.weight, self.patch_embed.proj.bias, stride=4)
        n, c, h, w = x.shape
        # tokens [N, H*W, C]: the conv output's storage when it is channels_last
        x = layer_norm(x.flatten(2).transpose(1, 2).contiguous(), self.patch_embed.norm.weight,
                       self.patch_embed.norm.bias, LN_EPS)
        hw = (h, w)
        kernel = window_kernel_applies(x, plan)
        for li, layer in enumerate(self.layers):
            eff, _ = block_window(hw, self.cfg["window"], 0)
            if hw[0] % eff or hw[1] % eff:
                raise ValueError(
                    f"swin features: stage {li} grid {hw[0]}x{hw[1]} is not divisible "
                    f"by window {eff} (the image size must give window-divisible or "
                    f"<= window grids at every stage, as in timm 0.6.5)")
            for bi, blk in enumerate(layer.blocks):
                window, shift = block_window(hw, self.cfg["window"], bi)
                x = blk(x, hw, window, shift, plan.gelu, kernel)
            if layer.downsample is not None:
                x, hw = layer.downsample(x, hw)
        return layer_norm(x, self.norm.weight, self.norm.bias, LN_EPS)

    def forward(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN) -> torch.Tensor:
        """[N, 3, H, W] -> [N, num_classes]: mean token pool, then the head."""
        return F.linear(self.features(x, plan).mean(dim=1), self.head.weight, self.head.bias)
