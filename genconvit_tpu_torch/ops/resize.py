"""Resizes as matmuls (port of genconvit_tpu/ops/resize.py:23-187).

Every resize here is a separable linear map: out = W_h^T @ img @ W_w with
per-size weight matrices computed once on the host with numpy (cached) and
two products on the device in float32:

  - cv2.resize INTER_AREA (`resize_area`; the face crops, ref
    model/pred_func.py:82-84, and the detector's windows), with cv2's
    2-tap fallback whenever either axis upscales;
  - a crop + INTER_AREA resize as ONE matmul per axis
    (`crop_resize_weights(_pair)`, `crop_resize_batch`), the face crops of
    the drivers (data/faces.crop_faces);
  - torchvision Resize(antialias=True) bilinear (`resize_bilinear_torch`),
    the VAE reconstruction, which the serving path never reads.

`round_to_u8` turns a float resize into the uint8 image cv2 would have
given (within 1 LSB: cv2 rounds its own fixed-point or float sums).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=4096)
def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    """Exact fractional-area-average weights, [in_size, out_size]: output
    pixel o averages the input span [o*s, (o+1)*s), s = in/out, with
    fractional end-pixel weights (cv2.INTER_AREA decimation)."""
    s = in_size / out_size
    w = np.zeros((in_size, out_size), dtype=np.float64)
    for o in range(out_size):
        a, b = o * s, (o + 1) * s
        i0, i1 = int(np.floor(a)), min(int(np.ceil(b)), in_size)
        for i in range(i0, i1):
            w[i, o] = max(0.0, (min(b, i + 1) - max(a, i))) / s
    return w.astype(np.float32)


def _crop_area_fallback_weights(in_size: int, lo: float, hi: float,
                                out_size: int) -> np.ndarray:
    """cv2's INTER_AREA generic-path coefficients (resize.cpp `area_mode`),
    the 2-tap scheme cv2 uses on BOTH axes whenever either axis upscales:
    sx = floor(dx*scale), fx = (dx+1) - (sx+1)/scale, taps (1-fx, fx) at
    (sx, sx+1), clamped at the crop's edges."""
    span = hi - lo
    w = np.zeros((in_size, out_size), dtype=np.float32)
    if span <= 0:
        return w
    scale = span / out_size
    inv_scale = out_size / span
    crop_last = max(int(np.ceil(span)) - 1, 0)  # last index within the crop
    base = max(int(np.floor(lo)), 0)
    for o in range(out_size):
        sx = int(np.floor(o * scale))
        fx = (o + 1) - (sx + 1) * inv_scale
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= crop_last:
            sx, fx = crop_last, 0.0
        a = min(base + sx, in_size - 1)
        b = min(base + sx + 1, in_size - 1)
        w[a, o] += 1.0 - fx
        w[b, o] += fx
    return w


@functools.lru_cache(maxsize=4096)
def _fallback_weights(in_size: int, out_size: int) -> np.ndarray:
    return _crop_area_fallback_weights(in_size, 0.0, float(in_size), out_size)


def area_weights_pair(in_hw: Tuple[int, int], out_hw: Tuple[int, int]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(wh [H, OH], ww [W, OW]) of cv2.resize INTER_AREA from in_hw to
    out_hw: the true area weights only when BOTH axes downscale, cv2's
    2-tap fallback on both otherwise."""
    upscale = in_hw[0] < out_hw[0] or in_hw[1] < out_hw[1]
    mk = _fallback_weights if upscale else _area_weights
    return mk(in_hw[0], out_hw[0]), mk(in_hw[1], out_hw[1])


def _as_float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.float()


def resize_area(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Batched cv2.resize(..., INTER_AREA) of x [N,H,W,C] (float or uint8)
    -> float [N,OH,OW,C], two products in x's float dtype (float32 for
    uint8) on x's device."""
    x = _as_float(x)
    wh, ww = (torch.from_numpy(w).to(x.device, x.dtype)
              for w in area_weights_pair(tuple(x.shape[1:3]), out_hw))
    y = torch.einsum("nhwc,hH->nHwc", x, wh)
    return torch.einsum("nHwc,wW->nHWc", y, ww)


def crop_resize_weights(in_size: int, lo: float, hi: float, out_size: int,
                        force_bilinear: bool = False) -> np.ndarray:
    """Weights [in_size, out_size] resampling the span [lo, hi) of an axis to
    out_size: crop + cv2.resize(INTER_AREA) as ONE matmul. Spans shorter
    than out_size take cv2's 2-tap fallback; cv2 applies it to BOTH axes
    when either upscales, so pass force_bilinear=True for the other axis
    of such a crop (crop_resize_weights_pair handles the coupling)."""
    if force_bilinear or (hi - lo) < out_size:
        return _crop_area_fallback_weights(in_size, lo, hi, out_size)
    s = (hi - lo) / out_size
    w = np.zeros((in_size, out_size), dtype=np.float32)
    if s <= 0:
        return w
    for o in range(out_size):
        a, b = lo + o * s, lo + (o + 1) * s
        i0 = max(int(np.floor(a)), 0)
        i1 = min(int(np.ceil(b)), in_size)
        for i in range(i0, i1):
            w[i, o] = max(0.0, (min(b, i + 1) - max(a, i))) / s
    return w


def crop_resize_weights_pair(h: int, w: int, box: Tuple[float, float, float, float],
                             out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(wh [h, out], ww [w, out]) for one (top, right, bottom, left) box,
    with cv2's coupled-axis INTER_AREA -> 2-tap fallback."""
    top, right, bottom, left = box
    bilinear = (bottom - top) < out_size or (right - left) < out_size
    return (crop_resize_weights(h, top, bottom, out_size, bilinear),
            crop_resize_weights(w, left, right, out_size, bilinear))


def crop_resize_batch(frames: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor
                      ) -> torch.Tensor:
    """Batched crop + resize on the device: frames [F,H,W,C] (uint8 or
    float), wh [F,H,OH], ww [F,W,OW] (per-frame crop_resize_weights) ->
    float [F,OH,OW,C], two batched products."""
    x = _as_float(frames)
    y = torch.einsum("fhwc,fhH->fHwc", x, wh.to(x.device, x.dtype))
    return torch.einsum("fHwc,fwW->fHWc", y, ww.to(x.device, x.dtype))


def round_to_u8(x: torch.Tensor) -> torch.Tensor:
    """A float image -> uint8 as cv2 saturates its sums: round half to even,
    clamp to [0, 255]."""
    return torch.round(x).clamp_(0, 255).to(torch.uint8)


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
