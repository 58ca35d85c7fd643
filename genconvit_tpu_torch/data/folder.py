"""ImageFolder data (port of genconvit_tpu/data/folder.py:22-97).

The reference's layout and label semantics (ref dataset/loader.py:81-122):
`{root}/{train,valid,test}/{class}/*.jpg` with classes ordered
alphabetically, so fake=0, real=1, which the output head's semantics rest
on (SURVEY.md §8 B2). Augmentation on train only.

Images stay numpy uint8 on the host (cv2 is imported when an image is
read); normalization runs on the device.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def scan_image_folder(split_dir: str) -> Tuple[List[str], List[int], List[str]]:
    """Returns (paths, labels, class_names) with alphabetical class order."""
    classes = sorted(
        d for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d)))
    paths: List[str] = []
    labels: List[int] = []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(split_dir, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    return paths, labels, classes


def load_image(path: str, img_size: Optional[int] = None) -> np.ndarray:
    """RGB uint8 HWC. Resizes (INTER_AREA down / LINEAR up) when img_size is
    given and the source differs — the reference assumes pre-sized images and
    would fail to batch otherwise (documented fix)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read image: {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img_size and img.shape[:2] != (img_size, img_size):
        interp = cv2.INTER_AREA if img.shape[0] > img_size else cv2.INTER_LINEAR
        img = cv2.resize(img, (img_size, img_size), interpolation=interp)
    return img


class FolderDataset:
    def __init__(self, split_dir: str, img_size: int = 224,
                 augment: bool = False, seed: int = 0):
        self.paths, self.labels, self.classes = scan_image_folder(split_dir)
        self.img_size = img_size
        self.augment = augment
        self.seed = seed

    def __len__(self) -> int:
        return len(self.paths)

    def batches(self, batch_size: int, shuffle: bool = False,
                epoch: int = 0, drop_last: bool = False,
                part: Optional[Callable[[int], slice]] = None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (images uint8 [B,S,S,3], labels int32 [B]).

        part: a function of a batch's length to the slice of its rows to
        read (a data-parallel rank's block, `parallel.mesh.shard_rows`).
        The images are then those rows alone and the labels still the
        whole batch's; the other rows are not read, and under augmentation
        only their random draws are made (`skip_aug`), so every row read
        equals the whole batch's."""
        from genconvit_tpu_torch.data import augment

        n = len(self.paths)
        order = np.arange(n)
        rng = np.random.default_rng(self.seed + epoch)
        if shuffle:
            rng.shuffle(order)
        size = (self.img_size, self.img_size) if self.img_size else (0, 0)
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            keep = range(len(idx))[part(len(idx))] if part else range(len(idx))
            imgs = [load_image(self.paths[idx[j]], self.img_size) for j in keep]
            if self.augment:
                mine = iter(imgs)
                imgs = []
                for j, i in enumerate(idx):
                    if j in keep:
                        imgs.append(augment.strong_aug(next(mine), rng))
                    else:
                        augment.skip_aug(size + (3,) if self.img_size else
                                         load_image(self.paths[i]).shape, rng)
            imgs = np.stack(imgs) if imgs else np.zeros((0,) + size + (3,), np.uint8)
            yield imgs, np.asarray([self.labels[i] for i in idx], np.int32)


def load_data(data_dir: str, batch_size: int = 32, img_size: int = 224,
              seed: int = 0) -> Tuple[Dict[str, FolderDataset], Dict[str, int]]:
    """Mirror of ref dataset/loader.py:81-122: train (augmented+shuffled),
    valid, test splits."""
    datasets = {
        "train": FolderDataset(os.path.join(data_dir, "train"), img_size,
                               augment=True, seed=seed),
        "valid": FolderDataset(os.path.join(data_dir, "valid"), img_size),
        "test": FolderDataset(os.path.join(data_dir, "test"), img_size),
    }
    sizes = {k: len(v) for k, v in datasets.items()}
    return datasets, sizes
