"""The cv2 host image ops that the skin detector and the detector's synthetic
data need, in numpy and scipy.ndimage, each with cv2's own arithmetic
(uint8 results bit-equal to cv2's, float32 ones to float rounding):

  rgb_to_ycrcb_u8     COLOR_RGB2YCrCb on uint8 (cv2's fixed point)
  in_range            inRange (inclusive bounds, 0/255)
  morph_open/_close   morphologyEx with a rectangle (its default border
                      never takes part)
  largest_component   connectedComponentsWithStats, 8-connected: the
                      largest component's stats, ties broken as cv2's labels
  rotation_matrix_2d  getRotationMatrix2D
  warp_affine_linear  warpAffine, INTER_LINEAR, BORDER_REFLECT or
                      BORDER_CONSTANT 0, on float32 images
  resize_area         resize INTER_AREA (cv2's area tables, integer-factor
                      blocks and upscale taps)
  resize_linear       resize INTER_LINEAR (uint8 in cv2's fixed point)

The card host has no cv2; these let the port's `skin` backend and
data/facedet_synth run there. Sizes follow cv2's: `dsize` is (width, height).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np

# cv2's RGB2YCrCb_i coefficients (color_yuv.simd.hpp), 14 fractional bits
_YR, _YG, _YB = 4899, 9617, 1868
_CR, _CB = 11682, 9241
_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)
_DELTA = 128 << _SHIFT


def rgb_to_ycrcb_u8(img: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] -> uint8 (Y, Cr, Cb) [..., 3], cv2's fixed point."""
    rgb = np.asarray(img).astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (r * _YR + g * _YG + b * _YB + _HALF) >> _SHIFT
    cr = ((r - y) * _CR + _DELTA + _HALF) >> _SHIFT
    cb = ((b - y) * _CB + _DELTA + _HALF) >> _SHIFT
    return np.clip(np.stack([y, cr, cb], axis=-1), 0, 255).astype(np.uint8)


def in_range(img: np.ndarray, lo: Sequence[float], hi: Sequence[float]) -> np.ndarray:
    """uint8 [H, W] mask: 255 where every channel lies in [lo, hi]."""
    img = np.asarray(img)
    ok = np.all((img >= np.asarray(lo)) & (img <= np.asarray(hi)), axis=-1)
    return ok.astype(np.uint8) * 255


def morph_open(mask: np.ndarray, k: int) -> np.ndarray:
    """Erode then dilate with a k x k rectangle, anchor at its centre. cv2's
    default border holds the extreme value, so it never takes part; for a
    rectangle, replicating the edge ('nearest') does the same."""
    from scipy import ndimage

    return ndimage.maximum_filter(ndimage.minimum_filter(mask, size=k, mode="nearest"),
                                  size=k, mode="nearest")


def morph_close(mask: np.ndarray, k: int) -> np.ndarray:
    """Dilate then erode with a k x k rectangle (morph_open's border rule)."""
    from scipy import ndimage

    return ndimage.minimum_filter(ndimage.maximum_filter(mask, size=k, mode="nearest"),
                                  size=k, mode="nearest")


def largest_component(mask: np.ndarray) -> Optional[Tuple[int, int, int, int, int]]:
    """(area, left, top, width, height) of the largest 8-connected component
    of the nonzero pixels, None without one. Of equal areas the one cv2
    labels first wins: cv2 scans 2 x 2 blocks, two rows at a time (Grana's
    and Bolelli's block-based labelling; its stripes in parallel runs are
    whole row pairs), and the pixels of a block are all 8-connected, so a
    component's label follows its first block in that scan."""
    from scipy import ndimage

    labels, n = ndimage.label(mask, structure=np.ones((3, 3), dtype=int))
    if n == 0:
        return None
    idx = np.arange(1, n + 1)
    areas = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    rows, cols = np.nonzero(labels)
    lab = labels[rows, cols]
    w_blocks = (mask.shape[1] + 1) // 2
    block = (rows // 2) * w_blocks + cols // 2
    first = np.full(n + 1, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(first, lab, block)
    best = idx[areas == areas.max()]
    b = int(best[np.argmin(first[best])])
    sl = ndimage.find_objects(labels)[b - 1]
    top, left = sl[0].start, sl[1].start
    return (int(areas[b - 1]), int(left), int(top), int(sl[1].stop - left),
            int(sl[0].stop - top))


def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """getRotationMatrix2D: the float64 [2, 3] matrix rotating by `angle`
    degrees (counter-clockwise) about center (x, y), scaled by `scale`."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], dtype=np.float64)


def _border_index(i: np.ndarray, n: int, border: str) -> Tuple[np.ndarray, np.ndarray]:
    """(index into [0, n), inside) for integer positions i: 'reflect' is
    cv2's BORDER_REFLECT (fedcba|abcdef, numpy's 'symmetric'); 'constant'
    marks positions outside as not inside."""
    inside = (i >= 0) & (i < n)
    if border == "constant":
        return np.clip(i, 0, n - 1), inside
    if border != "reflect":
        raise ValueError(f"unknown border {border!r}")
    m = np.mod(i, 2 * n)
    return np.where(m >= n, 2 * n - 1 - m, m), np.ones_like(inside)


def warp_affine_linear(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                       border: str = "constant") -> np.ndarray:
    """warpAffine(img, m, dsize, INTER_LINEAR) on a float32 [H, W] or
    [H, W, C] image: each output pixel (x, y) samples the input bilinearly
    at the inverse map of (x, y), at its exact sub-pixel position; taps
    outside the image read the border (`_border_index`; 'constant' reads 0)."""
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[:2]
    ow, oh = dsize
    inv = np.linalg.inv(np.vstack([np.asarray(m, np.float64), [0.0, 0.0, 1.0]]))[:2]
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = (sx - x0).astype(np.float32), (sy - y0).astype(np.float32)
    chans = img.ndim == 3
    out = np.zeros((oh, ow) + img.shape[2:], dtype=np.float32)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        yi, yin = _border_index(y0 + dy, h, border)
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi, xin = _border_index(x0 + dx, w, border)
            wgt = wy * wx * (yin & xin)
            out += img[yi, xi] * (wgt[..., None] if chans else wgt)
    return out


@functools.lru_cache(maxsize=256)
def _area_tab(n_in: int, n_out: int, scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's computeResizeAreaTab as (src [n_out, K], alpha [n_out, K]): row
    d lists the source pixels of output d in cv2's order, fractional edge
    pixels below 1e-3 of a pixel left out, padded with alpha 0 (adding
    0 * x changes no sum)."""
    tab = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        tab.append(row)
    k = max(len(row) for row in tab)
    src = np.zeros((n_out, k), dtype=np.int64)
    alpha = np.zeros((n_out, k), dtype=np.float32)
    for d, row in enumerate(tab):
        for j, (sx, a) in enumerate(row):
            src[d, j], alpha[d, j] = sx, a
    return src, alpha


def _area_mode_taps(n_in: int, n_out: int, inv_scale: float, clamp: bool):
    """INTER_AREA's taps where an axis upscales (resize.cpp `area_mode`):
    sx = floor(d * scale), f = (d + 1) - (sx + 1) / scale in float32, its
    fraction; cv2 applies them to both axes. Along x (`clamp`) f = 0 at the
    last pixel; along y the edge row is read twice."""
    scale = 1.0 / inv_scale
    sx = np.floor(np.arange(n_out) * scale).astype(np.int64)
    f = ((np.arange(n_out) + 1) - (sx + 1) * inv_scale).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    if clamp:
        f = np.where(sx >= n_in - 1, np.float32(0), f)
    return np.clip(sx, 0, n_in - 1), np.clip(sx + 1, 0, n_in - 1), f


def resize_area(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """resize(img, dsize, INTER_AREA) of an [H, W, C] uint8 or float32 image,
    as cv2 computes it: integer factors average their blocks (uint8 2x2:
    (sum + 2) >> 2); other downscales on both axes sum cv2's area tables in
    float32 in its order; an upscale on either axis takes the 2-tap
    `area_mode` taps on both (uint8 in `resize_linear`'s fixed point)."""
    w, h = dsize
    ih, iw = img.shape[:2]
    ix, iy = w / iw, h / ih          # cv2's inv_scale_x, inv_scale_y
    sx, sy = 1.0 / ix, 1.0 / iy
    u8 = img.dtype == np.uint8
    if sx < 1 or sy < 1:
        c0, c1, fc = _area_mode_taps(iw, w, ix, True)
        r0, r1, fr = _area_mode_taps(ih, h, iy, False)
        return _two_taps(img, (c0, c1, fc), (r0, r1, fr))
    if abs(sx - round(sx)) < np.finfo(float).eps and abs(sy - round(sy)) < np.finfo(float).eps:
        kx, ky = int(round(sx)), int(round(sy))
        x = img[: h * ky, : w * kx].astype(np.int64 if u8 else np.float32)
        tot = x.reshape(h, ky, w, kx, -1).sum(axis=(1, 3))
        if u8 and kx == ky == 2:
            return ((tot + 2) >> 2).astype(np.uint8)
        tot = tot.astype(np.float32) * np.float32(1.0 / (kx * ky))
        return np.clip(np.rint(tot), 0, 255).astype(np.uint8) if u8 else tot
    xs, xa = _area_tab(iw, w, sx)
    ys, ya = _area_tab(ih, h, sy)
    x = np.asarray(img, dtype=np.float32)
    # cv2 sums each output's source pixels in table order in float32: the
    # j-th term of every output at once keeps that order
    rows = x[:, xs[:, 0]] * xa[None, :, 0, None]
    for j in range(1, xs.shape[1]):
        rows += x[:, xs[:, j]] * xa[None, :, j, None]
    out = rows[ys[:, 0]] * ya[:, 0, None, None]
    for j in range(1, ys.shape[1]):
        out += rows[ys[:, j]] * ya[:, j, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8) if u8 else out


def _linear_taps(n_in: int, n_out: int, clamp: bool, u8: bool
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2's INTER_LINEAR taps along an axis (resize.cpp): (i0, i1, f) with
    output o = (1 - f) in[i0] + f in[i1] at s = (o + 0.5) n_in / n_out - 0.5,
    indices clipped to the image. For uint8 cv2 rounds s to float32 before
    it takes the fraction, for float32 images it takes it in double. Along
    x (`clamp`) f = 0 where s falls outside [0, n_in - 1); along y cv2
    keeps f and reads the edge row twice, which its fixed point floors
    twice."""
    s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    if u8:
        s = s.astype(np.float32)
    i0 = np.floor(s).astype(np.int64)
    f = (s - i0).astype(np.float32)
    if clamp:
        f = np.where((i0 < 0) | (i0 >= n_in - 1), np.float32(0), f)
    return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), f


def _two_taps(img: np.ndarray, cols, rows) -> np.ndarray:
    """A 2-tap separable resize with cv2's arithmetic: uint8 in fixed point
    (11-bit weights, the horizontal sums as integers, each vertical term
    (beta * (sum >> 4)) >> 16, then (terms + 2) >> 2), float32 in float."""
    c0, c1, fc = cols
    r0, r1, fr = rows
    if img.dtype != np.uint8:
        x = np.asarray(img, dtype=np.float32)
        x = x[:, c0] * (1 - fc)[None, :, None] + x[:, c1] * fc[None, :, None]
        return x[r0] * (1 - fr)[:, None, None] + x[r1] * fr[:, None, None]

    def coef(f):
        return (np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64),
                np.rint(f * np.float32(2048)).astype(np.int64))

    x = img.astype(np.int64)
    a0, a1 = coef(fc)
    hx = (x[:, c0] * a0[None, :, None] + x[:, c1] * a1[None, :, None]) >> 4
    b0, b1 = coef(fr)
    out = (((b0[:, None, None] * hx[r0]) >> 16) + ((b1[:, None, None] * hx[r1]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_linear(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """resize(img, dsize, INTER_LINEAR) of an [H, W, C] uint8 or float32
    image, with cv2's taps and arithmetic (`_two_taps`)."""
    w, h = dsize
    u8 = img.dtype == np.uint8
    return _two_taps(img, _linear_taps(img.shape[1], w, True, u8),
                     _linear_taps(img.shape[0], h, False, u8))
