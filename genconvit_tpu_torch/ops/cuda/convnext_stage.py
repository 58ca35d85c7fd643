"""K6: a chain of ConvNeXt blocks (a stage) as one hand-written CUDA kernel
(csrc/convnext_stage.cu), with its plain PyTorch version.

  fused_convnext_stage  replaces fused_convnext_stage (_stage_kernel) of
                        genconvit_tpu/ops/pallas/convnext_stage.py

K5's block math (ops/cuda/convnext_block.py) for every block of the chain,
the bf16 output of block b the input of block b+1 (convnext_stage.py:76-105),
with the GELU in the gelu_f32 form of ops/pallas/common.py: e = zc * P *
(1 / Q) with the hp coefficients and an exact reciprocal, whatever the
plan's tier. The wrapper takes x [N,H,W,C] and the chain's packs stacked on
a leading axis (`convnext_block.stack_blocks`); on a CPU tensor it runs the
plain version, on a CUDA tensor it launches the kernel (one launch for the
whole chain) or raises. It counts its kernel launches in `launches`.

The kernel is held against its plain version block by block (`stage_steps`),
each block at K5's bound, so that a fault confined to one block of a long
chain cannot hide in the chain's accumulated rounding noise. `k6_plan`
mirrors the kernel's plan (K5's, and the images per work item);
`library_k6_plan` asks the built library.
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from genconvit_tpu_torch.ops.act import gelu_rational_f32
from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda.convnext_block import (FusedBlockWeights, block_plain,
                                                         check_activation, check_weights,
                                                         k5_plan, kernel_operands,
                                                         planted_faults, stack_blocks)
from genconvit_tpu_torch.ops.cuda.convnext_mlp import _require, _stream

_GELU = partial(gelu_rational_f32, tier="hp")   # common.gelu_f32(hp=True), exact divide


def chain_block(blocks: FusedBlockWeights, b: int) -> FusedBlockWeights:
    """Block b's pack from a stacked chain."""
    return FusedBlockWeights(*(None if t is None else t[b] for t in blocks))


def chain_prefix(blocks: FusedBlockWeights, k: int) -> FusedBlockWeights:
    """The chain's first k blocks (views: contiguous, same alignment)."""
    return FusedBlockWeights(*(None if t is None else t[:k] for t in blocks))


def fused_convnext_stage_plain(x: torch.Tensor, blocks: FusedBlockWeights) -> torch.Tensor:
    """K6's math in plain PyTorch: block_plain for each block in order."""
    for b in range(blocks.w_dw.shape[0]):
        x = block_plain(x, chain_block(blocks, b), _GELU)
    return x


def stage_steps(run: Callable, x: torch.Tensor, blocks: FusedBlockWeights,
                truth: Optional[FusedBlockWeights] = None
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The chain held block by block: for each block k of `truth` (default:
    blocks), (its input x_k = run(x, blocks[:k]) (x for k = 0), run(x,
    blocks[:k+1]), block k of `truth` in plain PyTorch on x_k). Each step's
    kernel output differs from its plain output only by that one block's
    rounding flips. A chain `blocks` shorter than `truth` (a block skipped)
    repeats its full output at the steps past its end. Lazy: a caller that
    stops at the first failed step runs no more of the chain."""
    truth = blocks if truth is None else truth
    x_k = x
    for k in range(truth.w_dw.shape[0]):
        out = run(x, chain_prefix(blocks, k + 1))
        yield x_k, out, block_plain(x_k, chain_block(truth, k), _GELU)
        x_k = out


def chain_faults(packs: Sequence[FusedBlockWeights]) -> Dict[str, FusedBlockWeights]:
    """Wrong chains that the block-by-block check must refuse: each of K5's
    planted faults in every block, the LN bias dropped in the middle block
    alone, and for chains of two or more the middle block skipped and the
    blocks reversed."""
    per_block = [planted_faults(p) for p in packs]
    faults = {name: stack_blocks([f[name] for f in per_block]) for name in per_block[0]}
    nb, mid = len(packs), len(packs) // 2
    if nb > 1:
        faults[f"LN bias dropped in block {mid} only"] = stack_blocks(
            [per_block[b]["LN bias dropped"] if b == mid else p for b, p in enumerate(packs)])
        faults[f"block {mid} skipped"] = stack_blocks(list(packs[:mid]) + list(packs[mid + 1:]))
        faults["blocks reversed"] = stack_blocks(list(packs)[::-1])
    return faults


class StagePlan(NamedTuple):
    """K6's plan for one launch (csrc/convnext_stage.cu gcv_k6_plan): K5's
    plan at the width, and the whole images of a work item."""
    rows: int
    cols: int
    stages: int
    smem: int
    pairs: int
    images: int   # images per work item (block_wgmma.cuh k6_images)


def k6_images(n: int, hw: int, tile_rows: int, sms: int) -> int:
    """Images per work item: the fewest rounds of items over the SMs times
    an item's row tiles, and of equal costs the most images (fuller tiles,
    the weights streamed fewer times)."""
    best, best_cost = 1, None
    for g in range(1, n + 1):
        cost = -(-(-(-n // g)) // sms) * -(-(g * hw) // tile_rows)
        if best_cost is None or cost <= best_cost:
            best, best_cost = g, cost
    return best


def k6_plan(c: int, n: int, h: int, w: int, sms: int = 132) -> Optional[StagePlan]:
    """K6's plan for n images of h x w at width c on sms SMs (an H100 SXM
    has 132), as the CUDA source computes it; None where K6 does not take
    c (a multiple of 32 in [32, K1_MAX_C])."""
    p = k5_plan(c)
    if p is None:
        return None
    return StagePlan(*p, k6_images(n, h * w, p.rows, sms) if n > 0 and h * w > 0 else 0)


def library_k6_plan(c: int, n: int, h: int, w: int, sms: int) -> Optional[StagePlan]:
    """K6's plan as the built library computes it (loads the library); the
    card tests hold `k6_plan` against it."""
    out = (ctypes.c_int * 6)()
    return StagePlan(*out) if _build.load().gcv_k6_plan(c, n, h * w, sms, out) else None


def fused_convnext_stage(x: torch.Tensor, blocks: FusedBlockWeights) -> torch.Tensor:
    """K6: the chain of blocks (weights stacked [nb, ...]) on x [N,H,W,C];
    returns [N,H,W,C]."""
    if x.device.type == "cpu":
        return fused_convnext_stage_plain(x, blocks)
    what = "fused_convnext_stage"
    _require(x.is_cuda, what, f"unsupported device {x.device}")
    check_activation(what, x)
    n, h, w, c = x.shape
    nb = blocks.w_dw.shape[0] if blocks.w_dw.dim() == 3 else 0
    _require(nb >= 1, what, f"expected weights stacked [nb, ...], got w_dw {tuple(blocks.w_dw.shape)}")
    check_weights(what, blocks, c, x.device, (nb,))
    out = torch.empty_like(x)
    ws = torch.empty_like(x) if nb > 1 else None
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.gcv_fused_stage(
            x.data_ptr(), *(t.data_ptr() for t in kernel_operands(blocks)),
            None if ws is None else ws.data_ptr(), out.data_ptr(), n, h, w, c, nb,
            _stream(x.device))
    _build.check(err, what)
    fused_convnext_stage.launches += 1
    return out


fused_convnext_stage.launches = 0
