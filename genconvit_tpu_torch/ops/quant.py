"""Symmetric int8 quantizers with the JAX package's arithmetic (its
ops/pallas/int8_matmul.py `quantize_wint8` and ops/pallas/convnext_mlp.py
`_quant_cols_np`, `_quant_rows`, `_FIXED_ACT_CLIP`), so that the port's int8
weights and scales equal the JAX package's bit for bit.

All arithmetic is float32: scale = absmax / 127 (a zero column gets scale
1, so its int8 weights are exact zeros), q = clip(round(v / scale), +-127);
torch.round rounds half to even, as jnp.round and np.round do.
"""

from __future__ import annotations

from typing import Tuple

import torch

FIXED_ACT_CLIP = 8.0   # 'fc1' mode: int8 clip point of the LN output, in sigmas
_F32 = torch.float32


def _f32_const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on `like`'s device: the constant rounded to float32
    first, as JAX's weakly typed Python scalars are."""
    return torch.tensor(v, dtype=_F32, device=like.device)


def _quant(w: torch.Tensor, dim: int, one_where_scale_is_zero: bool):
    w32 = w.to(_F32)
    absmax = w32.abs().amax(dim=dim, keepdim=True)
    scale = absmax / 127.0
    zero = (scale == 0) if one_where_scale_is_zero else (absmax == 0)
    scale = torch.where(zero, torch.ones_like(scale), scale)
    wq = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return wq, scale.reshape(-1)


def quant_cols(w: torch.Tensor, dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column int8 of a folded MLP weight (`_quant_cols_np`): the
    absmax runs over `dim` (0 for a [K, N] matrix, as the JAX package
    stores it; 1 for the torch Linear layout [N, K]). Returns (wq int8 with
    w's shape, scale [N] float32) with w ~= wq * scale."""
    return _quant(w, dim, one_where_scale_is_zero=False)


def quantize_wint8(w: torch.Tensor, dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column int8 of a latent head (`quantize_wint8`): as quant_cols,
    except that scale 1 replaces a scale that is 0 (absmax / 127 may
    underflow where absmax does not)."""
    return _quant(w, dim, one_where_scale_is_zero=True)


def quant_rows(v32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of float32 activations [..., K] (the JAX `_quant_rows`):
    amax floored at 1e-30, q = clip(round(v * (127 / amax))) with an exact
    division, scale = amax * float32(1/127). Returns (q int8, scale [..., 1])."""
    amax = torch.clamp(v32.abs().amax(dim=-1, keepdim=True), min=1e-30)
    scale = amax * _f32_const(1.0 / 127.0, v32)
    q = torch.clamp(torch.round(v32 * (_f32_const(127.0, v32) / amax)), -127, 127)
    return q.to(torch.int8), scale


def quant_fixed(y32: torch.Tensor) -> torch.Tensor:
    """'fc1' mode's activation int8 with the fixed scale 127 / 8: LayerNorm
    rows have unit variance, so the clip at 8 sigmas needs no reduction."""
    q = torch.round(y32 * _f32_const(127.0 / FIXED_ACT_CLIP, y32))
    return torch.clamp(q, -127, 127).to(torch.int8)
