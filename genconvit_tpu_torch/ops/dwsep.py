"""Rank-R separable depthwise factorization, the opt-in approximate
inference of the kernel plan's `dw_rank` (port of
genconvit_tpu/ops/dwsep.py).

Each channel's 7x7 depthwise filter is SVD-factorized into R separable
rank-1 terms, a 1x7 row pass then a 7x1 column pass each (14R taps against
49). A trained filter is generally not rank-1, so this is an approximation
whose quality depends on the checkpoint: the Predictor applies it after the
dtype cast (never training) and logs the retained SVD energy of the
weights. Rank >= 7 reconstructs the 7x7 exactly.

The numpy code is the JAX package's, on the port's weight layout: the
depthwise weight [C, 1, kh, kw] gives the same [C, kh, kw] matrices, so
the factors are bit-equal to the JAX package's after the layout change.
`add_dw_sep_` attaches them to a module's ConvNeXt blocks as the buffers
`dw_row` [R, C, 1, 1, kw] and `dw_col` [R, C, 1, kh, 1] (rank r's row and
column filters are `dw_row[r]`, `dw_col[r]`), in the weight's dtype; the
depthwise conv of models/convnext.py dispatches on their presence.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

RankSpec = Union[int, str]


def parse_rank_spec(rank: RankSpec) -> Tuple[str, float, int]:
    """A dw_rank value as (mode, energy_bar, max_rank):

      R (an int, or an int-like str) -> ("fixed", 0.0, R)
      "auto:<energy>"                -> ("auto", energy, 3)
      "auto:<energy>:<max_rank>"     -> ("auto", energy, max_rank)

    Auto mode gives each block the smallest rank at which every channel
    retains the energy bar; a block that needs more than max_rank stays
    exact."""
    if isinstance(rank, int):
        return ("fixed", 0.0, rank)
    s = str(rank).strip()
    if not s.startswith("auto"):
        return ("fixed", 0.0, int(s or 0))
    parts = s.split(":")
    if len(parts) < 2 or len(parts) > 3:
        raise ValueError(f"bad dw_rank spec {rank!r}: want 'auto:<energy>"
                         f"[:<max_rank>]' or an integer rank")
    energy = float(parts[1])
    if not 0.0 < energy <= 1.0:
        raise ValueError(f"dw_rank auto energy bar must be in (0,1], got {energy}")
    max_rank = int(parts[2]) if len(parts) == 3 else 3
    if max_rank < 1:
        raise ValueError(f"dw_rank auto max_rank must be >=1, got {max_rank}")
    return ("auto", energy, max_rank)


def _matrices(weight: Any) -> np.ndarray:
    """[C, 1, kh, kw] depthwise weight -> the float32 [C, kh, kw] matrices."""
    w = np.asarray(weight, np.float32)
    assert w.ndim == 4 and w.shape[1] == 1, f"expected a depthwise [C,1,kh,kw] weight, got {w.shape}"
    return np.ascontiguousarray(w[:, 0])


def factorize_dw_kernel(weight: Any, rank: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """weight [C, 1, kh, kw] -> (kr [R, C, 1, 1, kw] row filters (applied
    first), kc [R, C, 1, kh, 1] column filters, energy [C] retained SVD
    energy in [0, 1]). The convolutions are cross-correlations, so the row
    pass then the column pass applies col_r x row_r, and the sum over r is
    the best rank-R approximation of each channel's filter."""
    m = _matrices(weight)
    u, s, vt = np.linalg.svd(m)                       # [C,kh,kh], [C,r], [C,kw,kw]
    r = min(rank, s.shape[1])
    sq = np.sqrt(s[:, :r])                            # s split across both passes
    col = u[:, :, :r] * sq[:, None, :]                # [C, kh, r]
    row = vt[:, :r, :] * sq[:, :, None]               # [C, r, kw]
    kr = row.transpose(1, 0, 2)[:, :, None, None, :]  # [r, C, 1, 1, kw]
    kc = col.transpose(2, 0, 1)[:, :, None, :, None]  # [r, C, 1, kh, 1]
    tot = np.sum(s * s, axis=1)
    energy = np.sum(s[:, :r] * s[:, :r], axis=1) / np.maximum(tot, 1e-30)
    return kr, kc, energy


def required_block_rank(weight: Any, energy_bar: float) -> int:
    """The smallest rank at which every channel of the block's depthwise
    weight retains at least energy_bar of its SVD energy."""
    s = np.linalg.svd(_matrices(weight), compute_uv=False)   # [C, r]
    s2 = s * s
    cum = np.cumsum(s2, axis=1) / np.maximum(s2.sum(axis=1, keepdims=True), 1e-30)
    need = np.argmax(cum >= energy_bar - 1e-9, axis=1) + 1
    return int(need.max())


@torch.no_grad()
def add_dw_sep_(module: torch.nn.Module, rank: RankSpec) -> Dict[str, Any]:
    """Attach separable factors to every ConvNeXt block of `module` (in
    module order), from the depthwise weight as stored (after the dtype
    cast: the weights the exact path convolves with), in its dtype and on
    its device. `rank`: an int (every block) or "auto:<energy>[:<max>]"
    (per block; a block needing more than max stays exact, without
    factors). Returns the JAX package's stats: count, energy_mean,
    energy_min over the channels factorized, blocks_sep, blocks_exact and
    rank_hist (rank -> blocks)."""
    from genconvit_tpu_torch.models.convnext import Block

    mode, energy_bar, max_rank = parse_rank_spec(rank)
    energies = []
    rank_hist: Dict[int, int] = {}
    blocks_exact = 0
    for blk in module.modules():
        if not isinstance(blk, Block):
            continue
        w = blk.conv_dw.weight
        w_np = w.detach().float().cpu().numpy()
        r = max_rank
        if mode == "auto":
            r = required_block_rank(w_np, energy_bar)
            if r > max_rank:
                blocks_exact += 1
                continue
        kr, kc, energy = factorize_dw_kernel(w_np, r)
        blk.dw_row = torch.from_numpy(np.ascontiguousarray(kr)).to(w.device, w.dtype)
        blk.dw_col = torch.from_numpy(np.ascontiguousarray(kc)).to(w.device, w.dtype)
        energies.append(energy)
        rank_hist[r] = rank_hist.get(r, 0) + 1
    if energies:
        all_e = np.concatenate(energies)
        stats: Dict[str, Any] = {"count": float(len(all_e)), "energy_mean": float(all_e.mean()),
                                 "energy_min": float(all_e.min())}
    else:
        stats = {"count": 0.0, "energy_mean": 1.0, "energy_min": 1.0}
    stats["blocks_sep"] = float(sum(rank_hist.values()))
    stats["blocks_exact"] = float(blocks_exact)
    stats["rank_hist"] = {int(k): int(v) for k, v in sorted(rank_hist.items())}
    return stats
