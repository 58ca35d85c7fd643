"""torchvision Resize(antialias=True) bilinear as two matmuls (port of
genconvit_tpu/ops/resize.py:40-68, 182-187), for the VAE reconstruction.

The per-size weight matrix is computed once on the host with numpy; the
serving path never reads the resized reconstruction and skips it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _bilinear_torch_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] PIL-style triangle-filter weights: the support
    scales with the downscale factor; plain 2-tap lerp when upscaling
    (align_corners=False mapping)."""
    scale = in_size / out_size
    w = np.zeros((in_size, out_size), dtype=np.float64)
    if scale > 1.0:
        support = scale
        inv = 1.0 / scale
        for o in range(out_size):
            center = (o + 0.5) * scale
            i0 = max(int(np.floor(center - support + 0.5)), 0)
            i1 = min(int(np.floor(center + support + 0.5)), in_size)
            t = 1.0 - np.abs((np.arange(i0, i1) + 0.5 - center) * inv)
            t = np.clip(t, 0.0, None)
            tot = t.sum()
            if tot > 0:
                w[i0:i1, o] = t / tot
    else:
        for o in range(out_size):
            c = (o + 0.5) * scale - 0.5
            i = int(np.floor(c))
            f = c - i
            lo, hi = np.clip(i, 0, in_size - 1), np.clip(i + 1, 0, in_size - 1)
            w[lo, o] += 1.0 - f
            w[hi, o] += f
    return w.astype(np.float32)


def resize_bilinear_torch(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[N,C,H,W] -> [N,C,out_h,out_w], torchvision-bilinear equivalent."""
    wh = torch.from_numpy(_bilinear_torch_weights(x.shape[2], out_hw[0]))
    ww = torch.from_numpy(_bilinear_torch_weights(x.shape[3], out_hw[1]))
    wh = wh.to(x.device, x.dtype)
    ww = ww.to(x.device, x.dtype)
    return torch.einsum("nchw,hH,wW->ncHW", x, wh, ww)
