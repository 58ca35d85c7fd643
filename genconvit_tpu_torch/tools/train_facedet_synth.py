"""Train the face detector from the reference's bundled media, offline (port
of the JAX package's tools/train_facedet_synth.py): synthetic composites of
the sample faces plus skin-weak-labelled sample-video frames
(data/facedet_synth.py), pregenerated once and reshuffled every epoch, a
cosine learning-rate decay, then a held-out evaluation (mean IoU of the top
detection on composites built from unseen faces).

    python -m genconvit_tpu_torch.tools.train_facedet_synth --ref REFERENCE_DIR \\
        [--out weight/facedet_synth.gcv] [--n 6144] [--epochs 40] [--batch 64] \\
        [--lr 2e-3] [--seed 0] [--device cuda]

REFERENCE_DIR holds sample_train_data/{train,valid,test}/{fake,real} and the
sample videos. The default output is not the JAX package's committed
detector (genconvit_tpu/assets/facedet.gcv), which this tool never writes.
It runs on the card unless --device cpu is given, and exits without CUDA.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Sequence, Tuple

import numpy as np
import torch

from genconvit_tpu_torch.data.facedet_synth import (composite_sample, load_face_crops,
                                                    load_video_frames, synth_dataset)
from genconvit_tpu_torch.models.facedet import FaceDet, detect_batch
from genconvit_tpu_torch.tools._timing import resolve_device
from genconvit_tpu_torch.tools.train_facedet import save_facedet

log = logging.getLogger("genconvit_tpu_torch")


@torch.no_grad()
def evaluate(model: FaceDet, faces: List[np.ndarray], frames: List[np.ndarray],
             n: int = 128, seed: int = 999) -> Tuple[float, float]:
    """Mean IoU of the best detection against the truth on n single-face
    composites, and the detection rate at IoU >= 0.5, on the model's device."""
    rng = np.random.default_rng(seed)
    imgs, gts = [], []
    while len(imgs) < n:
        img, boxes = composite_sample(faces, frames, rng)
        if len(boxes) != 1:
            continue
        imgs.append(img)
        gts.append(boxes[0])
    dev = next(model.parameters()).device
    scores, boxes = detect_batch(model, torch.from_numpy(np.stack(imgs)).to(dev),
                                 max_faces=1, score_thresh=0.1)
    boxes = boxes.cpu().numpy()[:, 0]
    scores = scores.cpu().numpy()[:, 0]
    ious = []
    for (cy, cx, h, w), (gcy, gcx, gh, gw), s in zip(boxes, gts, scores):
        if not np.isfinite(s):
            ious.append(0.0)
            continue
        t1, b1, l1, r1 = cy - h / 2, cy + h / 2, cx - w / 2, cx + w / 2
        t2, b2, l2, r2 = gcy - gh / 2, gcy + gh / 2, gcx - gw / 2, gcx + gw / 2
        ih = max(0.0, min(b1, b2) - max(t1, t2))
        iw = max(0.0, min(r1, r2) - max(l1, l2))
        inter = ih * iw
        union = h * w + gh * gw - inter
        ious.append(inter / max(union, 1e-9))
    ious = np.array(ious)
    return float(ious.mean()), float((ious >= 0.5).mean())


def train(train_faces: List[np.ndarray], heldout_faces: List[np.ndarray],
          frames: List[np.ndarray], *, n: int, epochs: int, batch: int, lr: float,
          seed: int, device) -> Tuple[FaceDet, float, float]:
    """The tool's flow on faces and frames in memory: pregenerate n samples,
    train with a cosine decay over (n // batch) * epochs steps, reshuffling
    the samples every epoch from seed + 1, then `evaluate` on held-out
    faces (the training faces where there are none). Returns (model, mean
    IoU, detection rate)."""
    from genconvit_tpu_torch.train.facedet_train import train_facedet

    log.info("pregenerating %d samples...", n)
    samples = list(synth_dataset(train_faces, frames, n, seed=seed))
    shuffle_rng = np.random.default_rng(seed + 1)

    class Reiterable:
        def __iter__(self):
            order = shuffle_rng.permutation(len(samples))
            return iter([samples[i] for i in order])

    steps = (n // batch) * epochs
    model = train_facedet(Reiterable(), epochs=epochs, batch_size=batch, lr=lr, seed=seed,
                          cosine_decay_steps=steps, device=device)
    miou, det = evaluate(model, heldout_faces or train_faces, frames)
    log.info("held-out composites: mean IoU %.3f, det-rate@0.5 %.3f", miou, det)
    return model, miou, det


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_facedet_synth")
    p.add_argument("--ref", required=True,
                   help="the reference's directory (sample_train_data, sample videos)")
    p.add_argument("--out", default="weight/facedet_synth.gcv")
    p.add_argument("--n", type=int, default=6144,
                   help="pregenerated composite count (reused every epoch)")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def main(argv: Sequence[str] = None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = resolve_device(args.device)

    train_faces = load_face_crops(
        os.path.join(args.ref, "sample_train_data"), ("train", "valid"))
    heldout_faces = load_face_crops(
        os.path.join(args.ref, "sample_train_data"), ("test",))
    frames = []
    for sub in ("sample_prediction_data", "sample_videos_kaggle"):
        d = os.path.join(args.ref, sub)
        if os.path.isdir(d):
            frames.extend(load_video_frames(d))
    log.info("foregrounds: %d train / %d held-out faces; %d bg frames",
             len(train_faces), len(heldout_faces), len(frames))
    if not train_faces:
        sys.exit("no face crops found under --ref")

    model, miou, det = train(train_faces, heldout_faces, frames, n=args.n, epochs=args.epochs,
                             batch=args.batch, lr=args.lr, seed=args.seed, device=device)
    save_facedet(args.out, model, heldout_mean_iou=miou, heldout_det_rate_at_05=det)
    print(f"saved {args.out} (mean IoU {miou:.3f}, det@0.5 {det:.3f})")


if __name__ == "__main__":
    main()
