"""ImageFolder evaluation on the PyTorch/CUDA port (the repository's
`evaluate.py`, the same flags plus --device):

    python -m genconvit_tpu_torch.evaluate --data DIR [--split test]
        [--net ed|vae|genconvit] [--weights-dir D] [--batch-size 32]
        [--img-size S] [--out-dir result/eval] [--device cuda|cpu]

Three parts: `score_batches` scores the images on the device (ImageNet
normalization, the GenConViT forward, for 'genconvit' the mean of the ED
and VAE logit blocks, a float32 softmax; the VAE's eps from the
Predictor's generator) and fetches P(class 1) once at the end; `report`
gives the classification report, confusion matrix and ROC-AUC in numpy
(evalx/metrics.py); the confusion-matrix figure needs matplotlib
(evalx/plots.py), and is drawn only where it is installed.

The report lists every class of the folder (`labels` = all class indices),
so a split whose predictions fall in one class still gets its report; the
repository's script asks sklearn for the classes present and stops there.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from genconvit_tpu_torch.data.preprocess import normalize_batch
from genconvit_tpu_torch.evalx.metrics import (classification_report, confusion_matrix,
                                               roc_auc_score)

log = logging.getLogger("genconvit_tpu_torch")


@torch.inference_mode()
def score_images(predictor, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B,S,S,3] on the predictor's device -> P(class 1) [B] float32
    there (evaluate.py:53-63 of the repository)."""
    x = normalize_batch(images_u8, predictor.dtype)
    logits = predictor.model(x, predictor.kernel_plan, sample=not predictor.deterministic_vae,
                             generator=predictor.generator)
    if predictor.net == "genconvit":   # the mean of the two branch blocks
        n = x.shape[0]
        logits = (logits[:n] + logits[n:]) / 2
    return torch.softmax(logits.float(), dim=-1)[:, 1]


def score_batches(predictor, batches: Iterable[Tuple[np.ndarray, np.ndarray]]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 [B,S,S,3], labels [B]) batches -> (y_true int64,
    P(class 1) float64) over all of them, with one fetch at the end."""
    labels: List[np.ndarray] = []
    probs: List[torch.Tensor] = []
    for imgs, lab in batches:
        probs.append(score_images(predictor, torch.from_numpy(np.ascontiguousarray(imgs))
                                  .to(predictor.device)))
        labels.append(np.asarray(lab, np.int64))
    if not probs:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    return np.concatenate(labels), torch.cat(probs).cpu().numpy().astype(np.float64)


def report(y_true: np.ndarray, y_prob: np.ndarray, classes: Sequence[str]
           ) -> Tuple[str, np.ndarray, Optional[float]]:
    """(classification report text, confusion matrix, ROC-AUC or None
    where y_true is not both classes 0 and 1) at the 0.5 threshold."""
    y_pred = (y_prob >= 0.5).astype(np.int64)
    labels = list(range(len(classes)))
    text = classification_report(y_true, y_pred, labels=labels, target_names=list(classes))
    cm = confusion_matrix(y_true, y_pred, labels=labels)
    auc = roc_auc_score(y_true, y_prob) if set(np.unique(y_true).tolist()) == {0, 1} else None
    return text, cm, auc


def gen_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("evaluate GenConViT on an ImageFolder split (PyTorch/CUDA)")
    p.add_argument("--data", required=True, help="ImageFolder root")
    p.add_argument("--split", default="test", help="subdir (test/valid/train), "
                   "or '.' if --data is already a class folder root")
    p.add_argument("--net", choices=["ed", "vae", "genconvit"], default="genconvit")
    p.add_argument("--weights-dir", default="weight")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--out-dir", default="result/eval")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI on argv; returns {'y_true', 'y_prob', 'report',
    'confusion', 'roc_auc', 'figure'} (figure None without matplotlib)."""
    from genconvit_tpu_torch.config import load_config
    from genconvit_tpu_torch.data.folder import FolderDataset
    from genconvit_tpu_torch.infer.engine import Predictor

    args = gen_parser().parse_args(argv)
    config = load_config()
    if args.img_size:
        config.img_size = args.img_size
        config.model.latent_dims = config.derived_latent_dims()
    config.weight_dir = args.weights_dir
    predictor = Predictor(config, net=args.net, device=args.device)

    split_dir = args.data if args.split == "." else os.path.join(args.data, args.split)
    ds = FolderDataset(split_dir, config.img_size)
    print(f"{len(ds)} images, classes {ds.classes}")
    y_true, y_prob = score_batches(predictor, ds.batches(args.batch_size))
    text, cm, auc = report(y_true, y_prob, ds.classes)
    print(text)
    print("confusion matrix:\n", cm)
    if auc is not None:
        print(f"ROC-AUC: {auc:.4f}")
    figure = None
    try:
        from genconvit_tpu_torch.evalx.plots import plot_confusion_matrix

        os.makedirs(args.out_dir, exist_ok=True)
        figure = plot_confusion_matrix(cm, ds.classes,
                                       os.path.join(args.out_dir, "confusion_matrix.png"))
        print(f"saved {figure}")
    except ImportError as e:   # a host without matplotlib: the report stands alone
        log.warning("confusion-matrix figure not drawn: %s", e)
    return {"y_true": y_true, "y_prob": y_prob, "report": text, "confusion": cm,
            "roc_auc": auc, "figure": figure}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
