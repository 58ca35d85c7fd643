"""Train the face detector from a WIDER-FACE-style annotation file (port of
the JAX package's tools/train_facedet.py).

Annotation JSON: {"<image path>": [[cy, cx, h, w], ...]} with normalized box
coordinates; images are read with cv2 and resized to 128x128 (INTER_AREA,
data/imgops.py). Training is train/facedet_train.train_facedet; the
`.gcv` written holds the JAX package's tree, so both packages'
load_checkpoint read it.

    python -m genconvit_tpu_torch.tools.train_facedet --ann boxes.json [--root .] \\
        --out weight/facedet.gcv [--epochs 20] [--batch 32] [--lr 1e-3] [--device cuda]

It runs on the card unless --device cpu is given, and exits without CUDA.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from genconvit_tpu_torch.core.checkpoint import save_checkpoint
from genconvit_tpu_torch.core.convert import tree_from_state_dict
from genconvit_tpu_torch.data import imgops
from genconvit_tpu_torch.models.facedet import INPUT_SIZE, FaceDet
from genconvit_tpu_torch.tools._timing import resolve_device


def dataset(ann, root, input_size):
    import cv2

    for path, boxes in ann.items():
        img = cv2.imread(os.path.join(root, path), cv2.IMREAD_COLOR)
        if img is None:
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        yield imgops.resize_area(img, (input_size, input_size)), boxes


def save_facedet(path: str, model: FaceDet, **extra) -> None:
    """The detector's weights as the JAX package's tree in a `.gcv`."""
    save_checkpoint(path, tree_from_state_dict(model.state_dict(), "facedet"),
                    extra={"kind": "facedet", **extra})


def main(argv=None):
    p = argparse.ArgumentParser("train_facedet")
    p.add_argument("--ann", required=True)
    p.add_argument("--root", default=".")
    p.add_argument("--out", default="weight/facedet.gcv")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from genconvit_tpu_torch.train.facedet_train import train_facedet

    device = resolve_device(args.device)
    with open(args.ann) as f:
        ann = json.load(f)

    class Reiterable:
        def __iter__(self):
            return dataset(ann, args.root, INPUT_SIZE)

    model = train_facedet(Reiterable(), epochs=args.epochs, batch_size=args.batch,
                          lr=args.lr, device=device)
    save_facedet(args.out, model)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
