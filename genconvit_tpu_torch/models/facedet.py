"""The face detector (port of genconvit_tpu/models/facedet.py): a compact
anchor-based CNN (BlazeFace-style) that scores 128x128 windows in batches
on the device.

128x128 input, a 5x5 stride-2 stem, depthwise-separable blocks to 16x16
(`blocks16`, strides 1,2,1,2,1) and 8x8 (`blocks8`, strides 2,1) feature
maps, 2 + 6 anchors per cell (896 in all), each with a score, a center
offset and a size. Decode and the greedy NMS run batched with static
shapes. The detector runs in float32, its convolutions in IEEE float32 on
cuDNN too (TF32 off for the forward); its trained weights are the JAX
package's `genconvit_tpu/assets/facedet.gcv` (data/faces.py reads it).
Keys: stem, blocks16.{i}.dw/pw, blocks8.{i}.dw/pw, head16, head8
(core/convert.py `state_dict_from_jax(tree, 'facedet')`).
"""

from __future__ import annotations

import functools
import threading
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

INPUT_SIZE = 128
_ANCHORS_16 = 2
_ANCHORS_8 = 6
_STRIDES_16 = (1, 2, 1, 2, 1)
_STRIDES_8 = (2, 1)
_CH_16 = ((24, 24), (24, 48), (48, 48), (48, 96), (96, 96))
_CH_8 = ((96, 96), (96, 96))
TOP_K = 32            # NMS candidates per image
OFFSET_SCALE = 0.1    # anchor center offsets, in units of the window
SIZE_SCALE = 0.2      # box sizes: exp(clip(raw, -4, 2)) * SIZE_SCALE
ALLOW_TF32 = False    # cuDNN's TF32 moves the scores by about 2e-2 against float32
# torch.backends.cudnn.allow_tf32 is process-wide: one detector forward at a
# time sets it and puts it back (other threads' float32 convolutions in that
# window run in IEEE float32 too; bfloat16 ones are unaffected)
_CUDNN_FLAG = threading.Lock()


class SepBlock(nn.Module):
    """Depthwise 3x3 (stride s) -> ReLU -> pointwise 1x1 (+ x where the
    shape allows) -> ReLU."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.dw = nn.Conv2d(cin, cin, 3, stride, 1, groups=cin)
        self.pw = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pw(F.relu(self.dw(x)))
        if self.stride == 1 and h.shape[1] == x.shape[1]:
            h = h + x
        return F.relu(h)


class FaceDet(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(3, 24, 5, 2, 2)
        self.blocks16 = nn.ModuleList(SepBlock(a, b, s) for (a, b), s in zip(_CH_16, _STRIDES_16))
        self.blocks8 = nn.ModuleList(SepBlock(a, b, s) for (a, b), s in zip(_CH_8, _STRIDES_8))
        self.head16 = nn.Conv2d(96, _ANCHORS_16 * 5, 1)
        self.head8 = nn.Conv2d(96, _ANCHORS_8 * 5, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N,3,128,128] in [-1, 1] -> raw anchor outputs [N,896,5]
        (score, dy, dx, log h, log w), anchors in the JAX package's order
        (cell row-major, then anchor)."""
        with _CUDNN_FLAG:
            prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = ALLOW_TF32
            try:
                return self._anchors(x)
            finally:
                torch.backends.cudnn.allow_tf32 = prev

    def _anchors(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.stem(x))
        for blk in self.blocks16:
            h = blk(h)
        o16 = self.head16(h)
        for blk in self.blocks8:
            h = blk(h)
        o8 = self.head8(h)
        n = x.shape[0]
        return torch.cat([o16.permute(0, 2, 3, 1).reshape(n, -1, 5),
                          o8.permute(0, 2, 3, 1).reshape(n, -1, 5)], dim=1)


@functools.lru_cache(maxsize=4)
def anchor_centers() -> np.ndarray:
    """[896, 2] (cy, cx) in [0, 1]."""
    out = []
    for grid, n in ((16, _ANCHORS_16), (8, _ANCHORS_8)):
        ys, xs = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
        c = np.stack([(ys + 0.5) / grid, (xs + 0.5) / grid], -1)
        out.append(np.repeat(c.reshape(-1, 2), n, axis=0))
    return np.concatenate(out).astype(np.float32)


def decode(raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """raw [N,896,5] -> (scores [N,896] logits, boxes [N,896,4] as (cy, cx,
    h, w) in [0, 1] window coordinates): facedet_apply's tail, :101-109."""
    centers = torch.from_numpy(anchor_centers()).to(raw.device)
    cy = centers[:, 0] + raw[..., 1] * OFFSET_SCALE
    cx = centers[:, 1] + raw[..., 2] * OFFSET_SCALE
    bh = torch.exp(raw[..., 3].clamp(-4, 2)) * SIZE_SCALE
    bw = torch.exp(raw[..., 4].clamp(-4, 2)) * SIZE_SCALE
    return raw[..., 0], torch.stack([cy, cx, bh, bw], dim=-1)


def _corners(b: torch.Tensor):
    return (b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
            b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2)


def _iou(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """box [N,4] vs boxes [N,K,4] (cy, cx, h, w) -> IoU [N,K]."""
    t1, l1, b1, r1 = (c[:, None] for c in _corners(box))
    t2, l2, b2, r2 = _corners(boxes)
    ih = (torch.minimum(b1, b2) - torch.maximum(t1, t2)).clamp(min=0)
    iw = (torch.minimum(r1, r2) - torch.maximum(l1, l2)).clamp(min=0)
    inter = ih * iw
    union = (box[:, 2] * box[:, 3])[:, None] + boxes[..., 2] * boxes[..., 3] - inter
    return inter / union.clamp(min=1e-9)


def nms(scores: torch.Tensor, boxes: torch.Tensor, *, max_out: int = 4,
        score_thresh: float = 0.0, iou_thresh: float = 0.3
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS batched over images: scores [N,A], boxes [N,A,4] ->
    (kept scores [N,max_out], kept boxes [N,max_out,4]). The TOP_K best
    candidates (ties: the lower index first), then max_out rounds that each
    take the best alive candidate (ties: the first) and suppress what
    overlaps it at IoU >= iou_thresh; a slot without a candidate above
    score_thresh holds score -inf and box 0."""
    n = scores.shape[0]
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :TOP_K], top_i[:, :TOP_K]
    top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    out_s = torch.full((n, max_out), float("-inf"), device=scores.device, dtype=scores.dtype)
    out_b = torch.zeros((n, max_out, 4), device=scores.device, dtype=boxes.dtype)
    alive = torch.ones_like(top_s, dtype=torch.bool)
    rows = torch.arange(n, device=scores.device)
    neg = torch.tensor(float("-inf"), device=scores.device, dtype=scores.dtype)
    for i in range(max_out):
        masked = torch.where(alive, top_s, neg)
        j = torch.argmax(masked, dim=1)
        best_s, best_b = masked[rows, j], top_b[rows, j]
        valid = best_s > score_thresh
        out_s[:, i] = torch.where(valid, best_s, neg)
        out_b[:, i] = torch.where(valid[:, None], best_b, torch.zeros_like(best_b))
        alive = alive & (_iou(best_b, top_b) < iou_thresh) & valid[:, None]
    return out_s, out_b


def detect_batch(model: FaceDet, frames_u8: torch.Tensor, *, max_faces: int = 4,
                 score_thresh: float = 0.5, iou_thresh: float = 0.3
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames_u8 [N,128,128,3] uint8 on the model's device -> (scores
    [N,max_faces] sigmoid, boxes [N,max_faces,4]) after NMS; float32."""
    x = (frames_u8.float() / 127.5 - 1.0).permute(0, 3, 1, 2)
    scores, boxes = decode(model(x))
    return nms(torch.sigmoid(scores), boxes, max_out=max_faces,
               score_thresh=score_thresh, iou_thresh=iou_thresh)
