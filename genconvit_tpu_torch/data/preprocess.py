"""Preprocessing (port of genconvit_tpu/data/preprocess.py:18-25, 35-106,
109-120).

The uint8 face batch goes to the device once; ImageNet normalization runs
there, producing the NCHW channels_last tensor the models take. The YUV420
transfer path ships planar Y, U and V instead (1.5 bytes a pixel against
RGB's 3) and converts on the device: `normalize_yuv420` returns the same
channels_last tensor as `normalize_batch`. Its colour math is per-channel
multiply-adds in float32, never a matmul, so that no TF32 flag rounds it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_batch(frames_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [N,H,W,3] -> normalized [N,3,H,W] in `dtype`, channels_last
    (the permute of the NHWC input is already that memory order)."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(frames_u8.device)
    std = torch.from_numpy(IMAGENET_STD).to(frames_u8.device)
    x = (frames_u8.float() / 255.0 - mean) / std
    return x.to(dtype).permute(0, 3, 1, 2)


# YUV -> RGB coefficient rows (R,G,B) x (Y,U,V) for limited/full range.
# Limited: c = 1.164(Y-16) + k(U-128, V-128); full: Y unscaled.
_YUV_COEFFS = {
    # (space, full_range): 3x3 matrix, offsets handled separately
    ("bt601", False): np.array([[1.164, 0.0, 1.596],
                                [1.164, -0.392, -0.813],
                                [1.164, 2.017, 0.0]], np.float32),
    ("bt709", False): np.array([[1.164, 0.0, 1.793],
                                [1.164, -0.213, -0.533],
                                [1.164, 2.112, 0.0]], np.float32),
    ("bt601", True): np.array([[1.0, 0.0, 1.402],
                               [1.0, -0.344, -0.714],
                               [1.0, 1.772, 0.0]], np.float32),
    ("bt709", True): np.array([[1.0, 0.0, 1.5748],
                               [1.0, -0.1873, -0.4681],
                               [1.0, 1.8556, 0.0]], np.float32),
}


def yuv_matrix(space: str = "bt601", full_range: bool = False) -> np.ndarray:
    return _YUV_COEFFS[(space, full_range)]


def yuv_affine(space: str = "bt601", full_range: bool = False) -> np.ndarray:
    """[3,4] affine YUV->RGB transform: rgb = A[:, :3] @ [Y,U,V] + A[:, 3].
    The range offsets (Y-16 for limited range, U/V-128) fold into the
    offset column, so one [V,3,4] batch keeps videos of mixed colour space
    and range exact."""
    m = _YUV_COEFFS[(space, full_range)]
    off = -m @ np.array([0.0 if full_range else 16.0, 128.0, 128.0], np.float32)
    return np.concatenate([m, off[:, None]], axis=1)


def _upsample_chroma(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N,h2,w2] -> [N,h,w]: nearest 2x2 repeat, cropped to [:h, :w]."""
    n, h2, w2 = c.shape
    return c[:, :, None, :, None].expand(n, h2, 2, w2, 2).reshape(n, 2 * h2, 2 * w2)[:, :h, :w]


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, matrix,
                  full_range: bool = False) -> torch.Tensor:
    """Planar YUV420 -> RGB float32 [N,H,W,3] on the 0..255 scale, on the
    planes' device.

    y: [N,H,W] uint8; u, v: [N,H/2,W/2] uint8; matrix (tensor or numpy):
    [3,3] / [N,3,3] coefficients (offsets from `full_range`), or [3,4] /
    [N,3,4] affine transforms from `yuv_affine` (offsets folded in).
    Chroma is upsampled by nearest 2x2 repeat; the result is clipped to
    0..255."""
    n, h, w = y.shape
    m = torch.as_tensor(matrix, dtype=torch.float32).to(y.device)
    affine = m.shape[-1] == 4
    yf = y.float() - (0.0 if (affine or full_range) else 16.0)
    uf = _upsample_chroma(u.float() - (0.0 if affine else 128.0), h, w)
    vf = _upsample_chroma(v.float() - (0.0 if affine else 128.0), h, w)
    if m.dim() == 3:   # one transform a frame: its coefficients broadcast over [H,W]
        m = m[:, None, None]
    rows = []
    for r in range(3):
        c = m[..., r, :]
        out = c[..., 0] * yf + c[..., 1] * uf + c[..., 2] * vf
        if affine:
            out = out + c[..., 3]
        rows.append(out)
    return torch.stack(rows, dim=-1).clamp_(0.0, 255.0)


def normalize_yuv420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, matrix,
                     dtype=torch.float32, full_range: bool = False) -> torch.Tensor:
    """YUV420 planes -> ImageNet-normalized [N,3,H,W] in `dtype`,
    channels_last, as `normalize_batch` returns it for RGB frames."""
    rgb = yuv420_to_rgb(y, u, v, matrix, full_range) / 255.0
    mean = torch.from_numpy(IMAGENET_MEAN).to(y.device)
    std = torch.from_numpy(IMAGENET_STD).to(y.device)
    return ((rgb - mean) / std).to(dtype).permute(0, 3, 1, 2)


def pad_faces(faces_u8, num_frames: int, img_size: int = 224) -> Tuple:
    """[k,S,S,3] uint8 (k may be 0..num_frames) -> fixed ([F,S,S,3], mask [F]),
    numpy for numpy faces, on the faces' device for a tensor."""
    k = len(faces_u8)
    if isinstance(faces_u8, torch.Tensor):
        dev = faces_u8.device
        batch = torch.zeros((num_frames, img_size, img_size, 3), dtype=torch.uint8, device=dev)
        batch[: min(k, num_frames)] = faces_u8[:num_frames]
        mask = torch.zeros((num_frames,), dtype=torch.float32, device=dev)
        mask[: min(k, num_frames)] = 1.0
        return batch, mask
    batch = np.zeros((num_frames, img_size, img_size, 3), dtype=np.uint8)
    if k:
        batch[:k] = faces_u8[:num_frames]
    mask = np.zeros((num_frames,), dtype=np.float32)
    mask[: min(k, num_frames)] = 1.0
    return batch, mask
