"""Synthetic training data for the on-device face detector (port of
genconvit_tpu/data/facedet_synth.py).

Face crops composited onto face-free backgrounds at known positions (exact
box labels), mixed with skin-heuristic weak labels on real video frames.
The paste is alpha-feathered, the crop randomly inset, and backgrounds keep
the videos' texture statistics (16x16 patch-shuffled frames), so border
artifacts and global colour are uninformative.

Every function draws from the caller's np.random.Generator in the JAX
module's order, with its numpy control flow kept as it is: the same seed
gives the same stream, boxes and draws. cv2's host ops run in numpy
(data/imgops.py): on uint8 images (the YCrCb conversion, inRange, the
skin detector's morphology and components, both resizes) they are
bit-equal to cv2's, so the skin veto in `_intact_crop`, which decides
which draws follow, decides as the JAX module does. The float32 face's
resize and warp agree with cv2's to float rounding, so a composite's
uint8 pixels can differ from the JAX module's by one where the blend
truncates at an integer.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from genconvit_tpu_torch.data import imgops
from genconvit_tpu_torch.data.faces import SkinDetector

Sample = Tuple[np.ndarray, List[List[float]]]  # (uint8 [S,S,3], [[cy,cx,h,w]])

INPUT = 128


def load_face_crops(root: str, splits: Sequence[str] = ("train", "valid")
                    ) -> List[np.ndarray]:
    """All face images under sample_train_data-style {split}/{fake,real},
    RGB uint8, read as data/folder.load_image reads them (cv2 at call time)."""
    import cv2

    faces = []
    for split in splits:
        for klass in ("fake", "real"):
            d = os.path.join(root, split, klass)
            if not os.path.isdir(d):
                continue
            for f in sorted(os.listdir(d)):
                img = cv2.imread(os.path.join(d, f), cv2.IMREAD_COLOR)
                if img is not None:
                    faces.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return faces


def load_video_frames(video_dir: str, per_video: int = 8,
                      max_videos: int = 12) -> List[np.ndarray]:
    from genconvit_tpu_torch.data.video import extract_frames

    frames: List[np.ndarray] = []
    vids = sorted(f for f in os.listdir(video_dir)
                  if f.lower().endswith((".mp4", ".avi", ".mov")))[:max_videos]
    for v in vids:
        try:
            fs = extract_frames(os.path.join(video_dir, v), per_video)
            frames.extend(list(fs))
        except Exception:
            continue
    return frames


def _patch_shuffle(img: np.ndarray, rng: np.random.Generator,
                   patch: int = 16) -> np.ndarray:
    """Destroy face structure, keep texture/color statistics."""
    h, w = img.shape[:2]
    hp, wp = h // patch, w // patch
    img = img[: hp * patch, : wp * patch]
    tiles = img.reshape(hp, patch, wp, patch, 3).transpose(0, 2, 1, 3, 4)
    tiles = tiles.reshape(hp * wp, patch, patch, 3)
    rng.shuffle(tiles, axis=0)
    # random per-tile flips for extra disorder
    flip = rng.integers(0, 2, len(tiles)).astype(bool)
    tiles[flip] = tiles[flip, ::-1]
    out = tiles.reshape(hp, wp, patch, patch, 3).transpose(0, 2, 1, 3, 4)
    return out.reshape(hp * patch, wp * patch, 3)


def _intact_crop(rng: np.random.Generator, frames: List[np.ndarray]
                 ) -> Optional[np.ndarray]:
    """Random intact crop of a real frame, steered away from the frame
    centre (where the talking head usually is); vetoed (None) when more
    than a tenth of it is skin, since it may hold the unlabelled face."""
    if not frames:
        return None
    f = frames[rng.integers(0, len(frames))]
    h, w = f.shape[:2]
    side = int(min(h, w) * rng.uniform(0.3, 0.9))
    # bias toward the frame edges: squaring a uniform draw concentrates
    # mass near 0; mirroring it to the right half makes both edges preferred
    if w > side:
        u = rng.random() ** 2 * (w - side)
        left = int(u if rng.random() < 0.5 else (w - side) - u)
    else:
        left = 0
    top = int(rng.integers(0, max(h - side, 1)))
    crop = f[top: top + side, left: left + side]
    crop = imgops.resize_area(crop, (INPUT, INPUT))
    ycrcb = imgops.rgb_to_ycrcb_u8(crop)
    skin = imgops.in_range(ycrcb, (0, 133, 77), (255, 180, 127))
    if skin.mean() / 255.0 > 0.10:
        return None
    return crop


def _background(rng: np.random.Generator, frames: List[np.ndarray]) -> np.ndarray:
    kind = rng.integers(0, 10)
    if kind < 4 and frames:  # intact real-frame crop (realistic negatives)
        bg = _intact_crop(rng, frames)
        if bg is not None:
            return bg
        kind = 5
    if kind < 6 and frames:  # patch-shuffled real frame
        f = frames[rng.integers(0, len(frames))]
        bg = _patch_shuffle(f, rng)
        bg = imgops.resize_area(bg, (INPUT, INPUT))
    elif kind < 8:  # smooth gradient
        a, b = rng.integers(0, 255, (2, 3))
        t = np.linspace(0, 1, INPUT)[:, None] if rng.random() < 0.5 \
            else np.linspace(0, 1, INPUT)[None, :]
        bg = (a + (b - a) * t[..., None]).astype(np.uint8)
        bg = np.broadcast_to(bg, (INPUT, INPUT, 3)).copy()
    else:  # textured noise
        bg = rng.integers(0, 255, (INPUT // 4, INPUT // 4, 3), np.uint8)
        bg = imgops.resize_linear(bg, (INPUT, INPUT))
    return bg


def _feather_alpha(h: int, w: int, margin: int) -> np.ndarray:
    """[h,w,1] alpha ramping 0 -> 1 over `margin` pixels at every edge."""
    ramp_y = np.minimum(np.arange(h) + 1, np.arange(h)[::-1] + 1)
    ramp_x = np.minimum(np.arange(w) + 1, np.arange(w)[::-1] + 1)
    a = np.minimum(ramp_y[:, None], ramp_x[None, :]).astype(np.float32)
    return np.clip(a / max(margin, 1), 0.0, 1.0)[..., None]


def _paste(canvas: np.ndarray, face: np.ndarray,
           rng: np.random.Generator) -> List[float]:
    """Paste one augmented face, return its [cy,cx,h,w] box (normalized)."""
    # random inward crop (vary the border content) + flip + photometric jitter
    fh, fw = face.shape[:2]
    iy, ix = rng.integers(0, fh // 10 + 1, 2)
    iy2, ix2 = rng.integers(0, fh // 10 + 1, 2)
    face = face[iy: fh - iy2 or fh, ix: fw - ix2 or fw]
    if rng.random() < 0.5:
        face = face[:, ::-1]
    face = face.astype(np.float32)
    face = face * rng.uniform(0.6, 1.3) + rng.uniform(-25, 25)
    face = np.clip(face, 0, 255)

    size = int(INPUT * rng.uniform(0.28, 0.85))
    # mildly non-square, like real detections
    sh = int(size * rng.uniform(0.9, 1.15))
    sw = size
    sh, sw = min(sh, INPUT - 2), min(sw, INPUT - 2)
    face = imgops.resize_area(face, (sw, sh))
    alpha = _feather_alpha(sh, sw, margin=max(2, size // 16))
    if rng.random() < 0.45:
        # pose augmentation: rotation + horizontal shear (sheared views
        # approximate the 3/4 and profile heads of some real footage)
        ang = rng.uniform(-22, 22)
        shear = rng.uniform(-0.35, 0.35)
        M = imgops.rotation_matrix_2d((sw / 2, sh / 2), ang, 1.0)
        M[0, 1] += shear
        M[0, 2] -= shear * sh / 2
        face = imgops.warp_affine_linear(face, M, (sw, sh), border="reflect")
        alpha = imgops.warp_affine_linear(alpha[..., 0], M, (sw, sh))[..., None]
    top = int(rng.integers(0, INPUT - sh))
    left = int(rng.integers(0, INPUT - sw))
    region = canvas[top: top + sh, left: left + sw].astype(np.float32)
    canvas[top: top + sh, left: left + sw] = (
        alpha * face + (1 - alpha) * region).astype(np.uint8)
    return [(top + sh / 2) / INPUT, (left + sw / 2) / INPUT,
            sh / INPUT, sw / INPUT]


def composite_sample(faces: List[np.ndarray], frames: List[np.ndarray],
                     rng: np.random.Generator) -> Sample:
    canvas = _background(rng, frames)
    boxes = []
    n_faces = 1 if rng.random() < 0.8 else 2
    for _ in range(n_faces):
        face = faces[rng.integers(0, len(faces))]
        boxes.append(_paste(canvas, face, rng))
    if rng.random() < 0.2:  # negatives: background-only images
        canvas = _background(rng, frames)
        boxes = []
    return canvas, boxes


def weak_label_sample(frames: List[np.ndarray],
                      rng: np.random.Generator) -> Optional[Sample]:
    """Skin-heuristic box on a real video frame (in-domain weak label)."""
    f = frames[rng.integers(0, len(frames))]
    boxes = SkinDetector().detect(f[None])[0]
    if not boxes:
        return None
    h, w = f.shape[:2]
    img = imgops.resize_area(f, (INPUT, INPUT))
    out = []
    for (top, right, bottom, left) in boxes:
        out.append([((top + bottom) / 2) / h, ((left + right) / 2) / w,
                    (bottom - top) / h, (right - left) / w])
    return img, out


def synth_dataset(faces: List[np.ndarray], frames: List[np.ndarray],
                  n: int, seed: int = 0,
                  weak_frac: float = 0.15) -> Iterator[Sample]:
    """n samples mixing exact composites with skin-weak-labeled frames."""
    rng = np.random.default_rng(seed)
    made = 0
    while made < n:
        if frames and rng.random() < weak_frac:
            s = weak_label_sample(frames, rng)
            if s is None:
                continue
        else:
            s = composite_sample(faces, frames, rng)
        yield s
        made += 1
