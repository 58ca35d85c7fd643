"""Preprocessing (port of genconvit_tpu/data/preprocess.py:18-25, 109-120).

The uint8 face batch goes to the device once; ImageNet normalization runs
there, producing the NCHW channels_last tensor the models take.
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
