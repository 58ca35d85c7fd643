"""Training recipe for the face detector (port of
genconvit_tpu/train/facedet_train.py; the model is models/facedet.py).

Anchor assignment on the host (IoU-nearest with a floor, plus the
best-anchor fallback per box), then a step of sigmoid-focal score loss and
Huber box regression on the positives, with Adam. Dataset: an iterable of
(image uint8 [128,128,3], boxes [[cy,cx,h,w] in 0..1]).
"""

from __future__ import annotations

import logging
import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from genconvit_tpu_torch.device import default_device
from genconvit_tpu_torch.models.facedet import _ANCHORS_16, FaceDet, anchor_centers, decode

_ANCHOR_SIZE = 0.2  # base box scale used by the decode (models/facedet.SIZE_SCALE)

log = logging.getLogger("genconvit_tpu_torch")


def assign_targets(boxes: Sequence[Sequence[float]]) -> Tuple[np.ndarray, np.ndarray]:
    """boxes [[cy,cx,h,w]] -> (labels [A] in {0,1}, regression [A,4]).

    Size-aware: small boxes match the fine 16x16 anchor grid, large boxes
    the coarse 8x8 grid. Regression targets invert the decode: dy/dx =
    (c - anchor_c) / 0.1, dh/dw = log(size / 0.2)."""
    centers = anchor_centers()
    a = len(centers)
    n16 = 16 * 16 * _ANCHORS_16
    labels = np.zeros((a,), np.float32)
    reg = np.zeros((a, 4), np.float32)
    for (cy, cx, h, w) in boxes:
        d2 = (centers[:, 0] - cy) ** 2 + (centers[:, 1] - cx) ** 2
        if max(h, w) <= 0.4:  # fine grid for small faces
            near = np.argsort(d2[:n16])[:3]
        else:  # coarse grid for large faces
            near = n16 + np.argsort(d2[n16:])[:3]
        near = np.concatenate([near, [int(np.argmin(d2))]])
        labels[near] = 1.0
        reg[near, 0] = (cy - centers[near, 0]) / 0.1
        reg[near, 1] = (cx - centers[near, 1]) / 0.1
        reg[near, 2] = np.log(max(h, 1e-3) / _ANCHOR_SIZE)
        reg[near, 3] = np.log(max(w, 1e-3) / _ANCHOR_SIZE)
    return labels, reg


def facedet_loss(model: FaceDet, images_u8: torch.Tensor, labels: torch.Tensor,
                 reg_targets: torch.Tensor, focal_gamma: float = 2.0,
                 box_weight: float = 1.0):
    """(loss, {"focal", "box"}) of a uint8 [N,128,128,3] batch (the JAX
    step's loss_fn): boxes decoded and inverted back to raw offsets (so the
    size terms carry the decode's clip), focal loss over every anchor,
    Huber (delta 1) box loss summed over the four terms, averaged over
    the positives."""
    x = (images_u8.float() / 127.5 - 1.0).permute(0, 3, 1, 2)
    scores, boxes = decode(model(x))
    centers = torch.from_numpy(anchor_centers()).to(boxes.device)
    raw = torch.stack([(boxes[..., 0] - centers[:, 0]) / 0.1,
                       (boxes[..., 1] - centers[:, 1]) / 0.1,
                       torch.log(boxes[..., 2] / _ANCHOR_SIZE),
                       torch.log(boxes[..., 3] / _ANCHOR_SIZE)], dim=-1)
    p = torch.sigmoid(scores)
    pt = torch.where(labels > 0.5, p, 1.0 - p)
    bce = -torch.log(torch.clamp(pt, min=1e-7))
    focal = ((1.0 - pt) ** focal_gamma * bce).mean()
    huber = F.huber_loss(raw, reg_targets, reduction="none", delta=1.0).sum(-1)
    pos = (labels > 0.5).float()
    box = torch.sum(huber * pos) / torch.clamp(pos.sum(), min=1.0)
    return focal + box_weight * box, {"focal": focal.detach(), "box": box.detach()}


def make_facedet_train_step(model: FaceDet, optimizer: torch.optim.Optimizer,
                            focal_gamma: float = 2.0, box_weight: float = 1.0):
    """step(images_u8, labels, reg) -> (loss, {"focal", "box"})."""

    def step(images_u8: torch.Tensor, labels: torch.Tensor, reg: torch.Tensor):
        optimizer.zero_grad(set_to_none=False)
        loss, aux = facedet_loss(model, images_u8, labels, reg, focal_gamma, box_weight)
        loss.backward()
        optimizer.step()
        return loss.detach(), aux

    return step


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.01):
    """optax.cosine_decay_schedule: lr * ((1 - alpha) * 0.5 (1 + cos(pi t / T))
    + alpha), t clipped to T."""

    def at(step: int) -> float:
        t = min(step, decay_steps) / decay_steps
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)

    return at


def train_facedet(
    dataset: Iterable[Tuple[np.ndarray, List[List[float]]]],
    *, epochs: int = 10, batch_size: int = 32, lr: float = 1e-3,
    seed: int = 0, model: Optional[FaceDet] = None, log_every: int = 20,
    cosine_decay_steps: int = 0, device=None,
) -> FaceDet:
    """Returns the trained model. `dataset` is re-iterated per epoch.
    cosine_decay_steps > 0: a cosine lr schedule (alpha 0.01) over that
    many optimizer steps. Without `model`, one initialized from `seed`
    (torch's default init; no parity with the JAX package's init)."""
    device = torch.device(device) if device is not None else default_device()
    if model is None:
        torch.manual_seed(seed)
        model = FaceDet()
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    sched = cosine_decay(lr, cosine_decay_steps) if cosine_decay_steps else None
    step = make_facedet_train_step(model, optimizer)
    n_steps = 0
    for epoch in range(epochs):
        imgs_buf, lab_buf, reg_buf = [], [], []
        losses = []
        for img, boxes in dataset:
            labels, reg = assign_targets(boxes)
            imgs_buf.append(img)
            lab_buf.append(labels)
            reg_buf.append(reg)
            if len(imgs_buf) == batch_size:
                if sched is not None:
                    for group in optimizer.param_groups:
                        group["lr"] = sched(n_steps)
                loss, _ = step(torch.from_numpy(np.stack(imgs_buf)).to(device),
                               torch.from_numpy(np.stack(lab_buf)).to(device),
                               torch.from_numpy(np.stack(reg_buf)).to(device))
                n_steps += 1
                losses.append(float(loss))
                imgs_buf, lab_buf, reg_buf = [], [], []
                if len(losses) % log_every == 0:
                    log.info("facedet epoch %d step %d loss %.4f", epoch, len(losses), losses[-1])
        if losses:
            log.info("facedet epoch %d mean loss %.4f", epoch, float(np.mean(losses)))
    return model
