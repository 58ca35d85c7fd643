"""Face-detection backends and the face crops (port of
genconvit_tpu/data/faces.py).

Boxes are (top, right, bottom, left), dlib's order; every face in every
frame counts toward the frame budget (quirk B7). Backends:

  fullframe  the whole frame as the "face" box
  center     a centered square crop
  skin       a YCrCb skin-segmentation heuristic (cv2's ops in numpy,
             data/imgops.py)
  haar       OpenCV 4 cascades through the native shim
             (native/libgcvfacedet.so; staged scored pipeline and box
             calibration, as the JAX package)
  jax        the trained detector of models/facedet.py on the device
             (`DeviceFaceDetector`; the backend keeps the JAX package's name)
  hybrid     the cascades fused with the device detector (the default)
  recorded   boxes from a JSON sidecar {video_basename: [[t,r,b,l], ...] per frame}

The device detector cuts its pyramid windows from the frames on the device
and resizes them there (ops/resize.py: cv2 INTER_AREA as two products, then
`round_to_u8`), and `crop_faces` crops and resizes the faces there too, so
a video's frames go to the device once for both. Frames and window crops
can differ from cv2's by 1 LSB (cv2 rounds its own sums), so boxes can
differ from the JAX package's by a pixel.

cv2 and the native shim load inside the functions that need them: importing
this module loads neither.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from genconvit_tpu_torch.data import imgops
from genconvit_tpu_torch.device import default_device
from genconvit_tpu_torch.ops.resize import (area_weights_pair, crop_resize_batch,
                                            crop_resize_weights_pair, resize_area,
                                            round_to_u8)

Box = Tuple[int, int, int, int]  # (top, right, bottom, left) — dlib order
Frames = np.ndarray              # RGB uint8 [F, H, W, 3]


class FaceDetector:
    """Base: detect(frames RGB uint8 [F,H,W,3]) -> per-frame list of boxes."""

    def detect(self, frames: Frames) -> List[List[Box]]:
        raise NotImplementedError

    def detect_many(self, frames_list: List[Frames],
                    device_frames: Optional[Sequence[torch.Tensor]] = None
                    ) -> List[List[List[Box]]]:
        """Several videos' frame stacks at once. `device_frames`, where
        given, holds the same frames already on the device (the drivers'
        one copy); device-backed detectors score every video's windows in
        one batched call from them, host detectors ignore them."""
        return [self.detect(f) for f in frames_list]


class FullFrameDetector(FaceDetector):
    def detect(self, frames: Frames) -> List[List[Box]]:
        h, w = frames.shape[1:3]
        return [[(0, w, h, 0)] for _ in range(len(frames))]


class CenterDetector(FaceDetector):
    """Centered square covering `frac` of the short side."""

    def __init__(self, frac: float = 0.85):
        self.frac = frac

    def detect(self, frames: Frames) -> List[List[Box]]:
        h, w = frames.shape[1:3]
        s = int(min(h, w) * self.frac)
        top, left = (h - s) // 2, (w - s) // 2
        return [[(top, left + s, top + s, left)] for _ in range(len(frames))]


class SkinDetector(FaceDetector):
    """Classical heuristic: skin mask in YCrCb, largest blob, squared box
    with headroom. Deterministic, no learned weights. cv2's host ops in
    numpy (data/imgops.py): the boxes are the JAX package's, with no cv2."""

    def __init__(self, min_area_frac: float = 0.01, expand: float = 1.25):
        self.min_area_frac = min_area_frac
        self.expand = expand

    def detect(self, frames: Frames) -> List[List[Box]]:
        out: List[List[Box]] = []
        for frame in frames:
            h, w = frame.shape[:2]
            mask = imgops.in_range(imgops.rgb_to_ycrcb_u8(frame), (0, 133, 77), (255, 180, 127))
            mask = imgops.morph_close(imgops.morph_open(mask, 5), 9)
            blob = imgops.largest_component(mask)
            boxes: List[Box] = []
            if blob is not None and blob[0] >= self.min_area_frac * h * w:
                _, x, y, bw, bh = blob
                cx, cy = x + bw / 2, y + bh / 2
                s = int(max(bw, bh) * self.expand)
                top = max(0, int(cy - s / 2))
                left = max(0, int(cx - s / 2))
                bottom = min(h, top + s)
                right = min(w, left + s)
                if bottom > top and right > left:
                    boxes.append((top, right, bottom, left))
            out.append(boxes)
        return out


SYSTEM_CASCADE_DIR = "/usr/share/opencv4/haarcascades"

# Box calibration toward the reference's dlib-HOG crop geometry, per-cascade
# medians of (dx_facing, dy, w_ratio, h_ratio) fitted by the JAX package on
# tests/fixtures/facedet_realframes.json (genconvit_tpu/data/faces.py:141-144).
HAAR_CALIBRATION = {
    "front": (-0.041, 0.129, 0.889, 0.968),
    "profile": (-0.114, 0.136, 0.860, 0.926),
}


def _apply_calib(box: Box, mirrored: bool, calib, h: int, w: int) -> Box:
    """Shift/scale a (t,r,b,l) box by calibration (dx_facing, dy, sw, sh);
    dx is in the facing direction, so it flips for mirrored detections."""
    dx, dy, sw, sh = calib
    t, r, b, l = box
    s = (b - t + r - l) / 2
    cy = (t + b) / 2 + dy * s
    cx = (l + r) / 2 + (-dx if mirrored else dx) * s
    hh, hw = (b - t) * sh / 2, (r - l) * sw / 2
    return (max(0, int(cy - hh)), min(w, int(cx + hw)),
            min(h, int(cy + hh)), max(0, int(cx - hw)))


def _find_cascade(name: str) -> Optional[str]:
    for d in (os.environ.get("GENCONVIT_HAAR_DIR", ""), SYSTEM_CASCADE_DIR):
        p = os.path.join(d, name) if d else ""
        if p and os.path.isfile(p):
            return p
    return None


class HaarDetector(FaceDetector):
    """Pretrained OpenCV cascades via the native shim (the cv2 5.x wheel
    removed the CascadeClassifier binding). Default mode is the JAX
    package's staged scored pipeline: the frontal cascade with per-detection
    confidences above `front_thresh`; frames without a confident frontal hit
    fall back to the profile cascade on the frame and its mirror; every kept
    box is calibrated (HAAR_CALIBRATION). A custom `cascade_path` selects
    the single-cascade legacy mode (unscored, uncalibrated)."""

    def __init__(self, cascade_path: Optional[str] = None,
                 profile: bool = True, scale_factor: float = 1.1,
                 min_neighbors: int = 5, max_faces: int = 4,
                 downscale: int = 1, front_thresh: float = 3.0,
                 prof_thresh: float = 0.0, calibrate: bool = True):
        import ctypes
        import queue
        import threading

        from genconvit_tpu_torch.data.native import load_facedet_lib

        self._lib = load_facedet_lib()
        if self._lib is None:
            # FileNotFoundError so the Predictor's backend ladder moves on
            raise FileNotFoundError(
                "native haar shim not built or not loadable — run `make -C native` "
                "(needs the system OpenCV 4 C++ libs)")
        self._custom = cascade_path is not None
        path = cascade_path or _find_cascade("haarcascade_frontalface_default.xml")
        if not path or not os.path.isfile(path):
            raise FileNotFoundError(f"Haar cascade not found: {path!r}")
        self._paths = [path]
        if profile and not self._custom:
            pp = _find_cascade("haarcascade_profileface.xml")
            if pp:
                self._paths.append(pp)
        self._scored = (not self._custom
                        and hasattr(self._lib, "gcv_haar_detect_scored"))
        # detectMultiScale is not thread-safe and the drivers call detect
        # from a thread pool: handle-sets are checked out of a pool per call,
        # bounded by the concurrency seen
        self._pool: "queue.SimpleQueue[List[int]]" = queue.SimpleQueue()
        self._all_handles: List[int] = []
        self._reg_lock = threading.Lock()
        self._ctypes = ctypes
        self.scale_factor = scale_factor
        self.min_neighbors = min_neighbors
        self.max_faces = max_faces
        self.front_thresh = front_thresh
        self.prof_thresh = prof_thresh
        self.calibrate = calibrate
        # detect on a 1/downscale frame, floored at a 360 px short side
        self.downscale = max(1, int(downscale))
        self._release_handles(self._checkout_handles())  # fail fast on a bad file

    def _checkout_handles(self) -> List[int]:
        import queue

        try:
            return self._pool.get_nowait()
        except queue.Empty:
            pass
        handles = []
        for p in self._paths:
            h = self._lib.gcv_haar_create(p.encode())
            if not h:
                raise ValueError(f"failed to load cascade {p!r}")
            handles.append(h)
        with self._reg_lock:
            self._all_handles.extend(handles)
        return handles

    def _release_handles(self, handles: List[int]) -> None:
        self._pool.put(handles)

    def __del__(self):
        for h in getattr(self, "_all_handles", []):
            try:
                self._lib.gcv_haar_destroy(h)
            except Exception:
                pass

    def _effective_downscale(self, frames: Frames) -> int:
        ds = self.downscale
        while ds > 1 and min(frames.shape[1], frames.shape[2]) // ds < 360:
            ds -= 1
        return ds

    def _gray_frames(self, frames: Frames, ds: int):
        import cv2

        n = len(frames)
        h, w = frames.shape[1] // ds, frames.shape[2] // ds
        gray = np.empty((n, h, w), np.uint8)
        for i, f in enumerate(frames):
            g = cv2.cvtColor(f, cv2.COLOR_RGB2GRAY)
            gray[i] = g if ds == 1 else cv2.resize(g, (w, h), interpolation=cv2.INTER_AREA)
        return gray

    def _run_scored(self, handle, gray: np.ndarray):
        """(rects [n,max,4] xywh, weights [n,max], counts [n]) on gray."""
        ct = self._ctypes
        n, h, w = gray.shape
        min_size = max(24, int(0.05 * min(h, w)))
        rects = np.zeros((n, self.max_faces, 4), np.int32)
        weights = np.zeros((n, self.max_faces), np.float64)
        counts = np.zeros(n, np.int32)
        rc = self._lib.gcv_haar_detect_scored(
            handle, gray.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            n, h, w, ct.c_double(self.scale_factor), self.min_neighbors,
            min_size, rects.ctypes.data_as(ct.POINTER(ct.c_int32)),
            weights.ctypes.data_as(ct.POINTER(ct.c_double)),
            counts.ctypes.data_as(ct.POINTER(ct.c_int32)), self.max_faces)
        if rc != 0:
            raise RuntimeError("gcv_haar_detect_scored failed")
        return rects, weights, counts

    def detect(self, frames: Frames) -> List[List[Box]]:
        handles = self._checkout_handles()
        try:
            if not self._scored:
                return self._detect_legacy(frames, handles)
            return self._detect_staged(frames, handles)
        finally:
            self._release_handles(handles)

    def _detect_staged(self, frames: Frames, handles: List[int]) -> List[List[Box]]:
        n = len(frames)
        ds = self._effective_downscale(frames)
        H, W = frames.shape[1], frames.shape[2]
        gray = self._gray_frames(frames, ds)
        cal_f = HAAR_CALIBRATION["front"] if self.calibrate else (0, 0, 1, 1)
        cal_p = HAAR_CALIBRATION["profile"] if self.calibrate else (0, 0, 1, 1)

        out: List[List[Box]] = [[] for _ in range(n)]
        rects, weights, counts = self._run_scored(handles[0], gray)
        for i in range(n):
            for j in range(counts[i]):
                if weights[i, j] < self.front_thresh:
                    break  # descending-weight order
                x, y, bw, bh = rects[i, j]
                box = (int(y) * ds, int(x + bw) * ds, int(y + bh) * ds, int(x) * ds)
                out[i].append(_apply_calib(box, False, cal_f, H, W))

        pending = [i for i in range(n) if not out[i]]
        if pending and len(handles) > 1:
            sub = gray[pending]
            best: Dict[int, Tuple[float, Box]] = {}
            for mirrored, g in ((False, sub), (True, sub[:, :, ::-1].copy())):
                rects, weights, counts = self._run_scored(handles[1], g)
                for k, i in enumerate(pending):
                    for j in range(counts[k]):
                        wt = float(weights[k, j])
                        if wt < self.prof_thresh:
                            break
                        x, y, bw, bh = rects[k, j]
                        if mirrored:
                            box = (int(y) * ds, (gray.shape[2] - int(x)) * ds,
                                   int(y + bh) * ds, (gray.shape[2] - int(x + bw)) * ds)
                        else:
                            box = (int(y) * ds, int(x + bw) * ds,
                                   int(y + bh) * ds, int(x) * ds)
                        if i not in best or wt > best[i][0]:
                            best[i] = (wt, _apply_calib(box, mirrored, cal_p, H, W))
            for i, (_, box) in best.items():
                out[i].append(box)
        return [b[: self.max_faces] for b in out]

    def _detect_legacy(self, frames: Frames, handles: List[int]) -> List[List[Box]]:
        """Unscored single-pass path: custom cascade files, a shim without
        the scored entry point."""
        ct = self._ctypes
        n = len(frames)
        ds = self._effective_downscale(frames)
        gray = self._gray_frames(frames, ds)
        h, w = gray.shape[1:]
        min_size = max(24, int(0.05 * min(h, w)))
        out: List[List[Box]] = [[] for _ in range(n)]
        rects = np.zeros((n, self.max_faces, 4), np.int32)
        counts = np.zeros(n, np.int32)
        for handle in handles:
            rc = self._lib.gcv_haar_detect(
                handle, gray.ctypes.data_as(ct.POINTER(ct.c_uint8)),
                n, h, w, ct.c_double(self.scale_factor),
                self.min_neighbors, min_size,
                rects.ctypes.data_as(ct.POINTER(ct.c_int32)),
                counts.ctypes.data_as(ct.POINTER(ct.c_int32)),
                self.max_faces)
            if rc != 0:
                raise RuntimeError("gcv_haar_detect failed")
            for i in range(n):
                for x, y, bw, bh in rects[i, : counts[i]]:
                    box = (int(y) * ds, int(x + bw) * ds, int(y + bh) * ds, int(x) * ds)
                    # frontal + profile can double-report the same face
                    if all(_box_iou(box, b) < 0.45 for b in out[i]):
                        out[i].append(box)
        return [b[: self.max_faces] for b in out]


class HybridFaceDetector(FaceDetector):
    """The cascades fused with the device detector (the JAX package's
    quality leader on its real-frame fixture). Per frame: confident cascade
    boxes win, each averaged with an agreeing device-detector box (weight
    `fuse_weight`, overlap gate `fuse_iou`); frames without a cascade hit
    take the device detector's boxes."""

    def __init__(self, checkpoint: Optional[str] = None,
                 haar_downscale: int = 1, downscale: Optional[int] = None,
                 fuse_weight: float = 0.8, fuse_iou: float = 0.4,
                 device=None, **kwargs):
        self.haar = HaarDetector(
            downscale=downscale if downscale is not None else haar_downscale,
            **{k: v for k, v in kwargs.items()
               if k in ("profile", "scale_factor", "min_neighbors",
                        "max_faces", "front_thresh", "prof_thresh",
                        "calibrate")})
        self.jax = DeviceFaceDetector(
            checkpoint or default_facedet_checkpoint(), device=device,
            **{k: v for k, v in kwargs.items()
               if k in ("score_thresh", "max_faces", "fuse")})
        self.fuse_weight = fuse_weight
        self.fuse_iou = fuse_iou

    def detect(self, frames: Frames) -> List[List[Box]]:
        return self.detect_many([frames])[0]

    def detect_many(self, frames_list: List[Frames],
                    device_frames: Optional[Sequence[torch.Tensor]] = None
                    ) -> List[List[List[Box]]]:
        """Cascades per video on the host; the device detector over all
        videos in one batched pass; fusion per frame."""
        haar_all = [self.haar.detect(f) for f in frames_list]
        dev_all = self.jax.detect_many(frames_list, device_frames)
        return [self._fuse_video(hb, jb) for hb, jb in zip(haar_all, dev_all)]

    def _fuse_video(self, haar_boxes: List[List[Box]],
                    dev_boxes: List[List[Box]]) -> List[List[Box]]:
        out: List[List[Box]] = []
        for hb, jb in zip(haar_boxes, dev_boxes):
            if not hb:
                out.append(jb)
                continue
            if not jb or self.fuse_weight <= 0:
                out.append(hb)
                continue
            fused = []
            for box in hb:
                match = max(jb, key=lambda j: _box_iou(box, j))
                if _box_iou(box, match) >= self.fuse_iou:
                    wj = self.fuse_weight
                    box = tuple(int(round((box[i] + wj * match[i]) / (1 + wj)))
                                for i in range(4))
                fused.append(box)  # type: ignore[arg-type]
            out.append(fused)
        return out


def _box_iou(a: Box, b: Box) -> float:
    ih = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iw = max(0, min(a[1], b[1]) - max(a[3], b[3]))
    inter = ih * iw
    union = ((a[2] - a[0]) * (a[1] - a[3])
             + (b[2] - b[0]) * (b[1] - b[3]) - inter)
    return inter / union if union > 0 else 0.0


class RecordedDetector(FaceDetector):
    """Exact-parity mode: boxes recorded from the reference's dlib-HOG run.
    Sidecar schema: {"<video basename>": [[ [t,r,b,l], ...] per sampled frame]}"""

    def __init__(self, sidecar_path: str, video_name: Optional[str] = None):
        with open(sidecar_path) as f:
            self._all = json.load(f)
        self._name = video_name

    def for_video(self, video_name: str) -> "RecordedDetector":
        d = RecordedDetector.__new__(RecordedDetector)
        d._all = self._all
        d._name = video_name
        return d

    def detect(self, frames: Frames) -> List[List[Box]]:
        per_frame = self._all.get(self._name or "", [])
        out: List[List[Box]] = []
        for i in range(len(frames)):
            boxes = per_frame[i] if i < len(per_frame) else []
            out.append([tuple(int(v) for v in b) for b in boxes])
        return out


class DeviceFaceDetector(FaceDetector):
    """The trained detector (models/facedet.py) on the device: every frame's
    pyramid windows, of every video of a call, scored in batched passes.
    Window geometry, thresholds and the cross-window merge are the JAX
    package's `JaxFaceDetector` (:518-712); the windows are cut and
    resized on the device."""

    batch = 2048   # windows per detector pass (bounds the activations' memory)

    def __init__(self, checkpoint: Optional[str] = None,
                 score_thresh: float = 0.3, max_faces: int = 4,
                 fuse: bool = True, device=None):
        # score_thresh 0.3: the JAX package's choice for the committed
        # checkpoint on real frames (top scores 0.33-0.63, :537-540 there)
        from genconvit_tpu_torch.core.checkpoint import load_checkpoint
        from genconvit_tpu_torch.core.convert import state_dict_from_jax
        from genconvit_tpu_torch.models.facedet import INPUT_SIZE, FaceDet

        self._input = INPUT_SIZE
        self.score_thresh = score_thresh
        self.max_faces = max_faces
        self.fuse = fuse
        self.device = torch.device(device) if device is not None else default_device()
        if not (checkpoint and os.path.isfile(checkpoint)):
            # a random-weight detector silently finds nothing, which looks
            # like "no faces in this video": refuse
            raise FileNotFoundError(
                f"face detector: no trained checkpoint at {checkpoint!r} "
                f"(set GENCONVIT_FACEDET_CKPT or restore genconvit_tpu/assets/facedet.gcv)")
        model = FaceDet()
        tree = load_checkpoint(checkpoint)["params"]
        model.load_state_dict(state_dict_from_jax(tree, "facedet"), strict=True)
        self.model = model.to(self.device).eval()

    @staticmethod
    def _starts(dim: int, side: int) -> np.ndarray:
        """Window starts covering [0, dim) with >= 50% overlap."""
        if side >= dim:
            return np.zeros(1, np.int64)
        n = int(np.ceil((dim - side) / (side / 2))) + 1
        return np.unique(np.round(np.linspace(0, dim - side, n)).astype(np.int64))

    def _windows(self, h: int, w: int) -> List[Tuple[int, int, int]]:
        """(top, left, side) square windows of an aspect-preserving pyramid
        (scales 1, 1/2, 1/3 of the short side past 2 x 128 px, else 1), and
        (0, 0, -1), the whole frame squeezed, where h != w."""
        m = min(h, w)
        scales = (1.0,) if m <= 2 * self._input else (1.0, 0.5, 1 / 3)
        wins: List[Tuple[int, int, int]] = []
        if h != w:
            wins.append((0, 0, -1))
        for s in scales:
            side = int(round(m * s))
            if side < 2 * self._input and s != 1.0:
                continue  # upsampled-noise windows
            for top in self._starts(h, side):
                for left in self._starts(w, side):
                    wins.append((int(top), int(left), side))
        return wins

    def window_crops(self, frames: torch.Tensor, wins: List[Tuple[int, int, int]]
                     ) -> torch.Tensor:
        """frames [F,H,W,3] uint8 on the device -> the windows resized to
        128 x 128 as cv2.resize INTER_AREA would, uint8 [F * len(wins),
        128, 128, 3] (frame-major). Windows of one side share one pair of
        weights; each distinct top takes one product over the rows, each
        window one over its columns."""
        f = frames.shape[0]
        s = self._input
        x = frames.float()
        out = torch.empty((f, len(wins), s, s, 3), dtype=torch.uint8, device=frames.device)
        by_side: Dict[int, Dict[int, List[Tuple[int, int]]]] = {}
        for i, (top, left, side) in enumerate(wins):
            by_side.setdefault(side, {}).setdefault(top, []).append((i, left))
        for side, tops in by_side.items():
            if side < 0:
                out[:, tops[0][0][0]] = round_to_u8(resize_area(x, (s, s)))
                continue
            wh, ww = (torch.from_numpy(a).to(x.device)
                      for a in area_weights_pair((side, side), (s, s)))
            for top, items in tops.items():
                rows = torch.einsum("fhwc,hH->fHwc", x[:, top: top + side], wh)
                cols = torch.stack([rows[:, :, left: left + side] for _, left in items])
                res = torch.einsum("nfHwc,wW->nfHWc", cols, ww)
                out[:, [i for i, _ in items]] = round_to_u8(res).transpose(0, 1)
        return out.reshape(f * len(wins), s, s, 3)

    def detect(self, frames: Frames) -> List[List[Box]]:
        return self.detect_many([frames])[0]

    @torch.inference_mode()
    def detect_many(self, frames_list: List[Frames],
                    device_frames: Optional[Sequence[torch.Tensor]] = None
                    ) -> List[List[List[Box]]]:
        from genconvit_tpu_torch.models.facedet import detect_batch

        per_video = []  # (wins, n_frames, h, w)
        crops = []
        for vi, frames in enumerate(frames_list):
            h, w = frames.shape[1:3]
            wins = self._windows(h, w)
            per_video.append((wins, len(frames), h, w))
            if len(frames):
                x = (device_frames[vi] if device_frames is not None else
                     torch.from_numpy(np.ascontiguousarray(frames)).to(self.device))
                crops.append(self.window_crops(x, wins))
        if not crops:
            return [[[] for _ in range(n)] for _, n, _, _ in per_video]
        scores, boxes = [], []
        for chunk in torch.cat(crops).split(self.batch):
            sc, bx = detect_batch(self.model, chunk, max_faces=self.max_faces,
                                  score_thresh=self.score_thresh)
            scores.append(sc)
            boxes.append(bx)
        scores_all = torch.cat(scores).cpu().numpy()
        boxes_all = torch.cat(boxes).cpu().numpy()
        out: List[List[List[Box]]] = []
        off = 0
        for wins, n_frames, h, w in per_video:
            k = n_frames * len(wins)
            if k == 0:
                out.append([[] for _ in range(n_frames)])
                continue
            sc = scores_all[off: off + k].reshape(n_frames, len(wins), -1)
            bx = boxes_all[off: off + k].reshape(n_frames, len(wins), -1, 4)
            off += k
            out.append([[box for _, box in self._merge(self._candidates(sc[fi], bx[fi], wins, h, w))]
                        for fi in range(n_frames)])
        return out

    def _candidates(self, scores: np.ndarray, boxes: np.ndarray,
                    wins: List[Tuple[int, int, int]], h: int, w: int
                    ) -> List[Tuple[float, Box]]:
        """One frame's kept detections in frame coordinates (the JAX
        package's host arithmetic, float32 as there)."""
        cands: List[Tuple[float, Box]] = []
        for wi, (top0, left0, side) in enumerate(wins):
            sy, sx = (h, w) if side < 0 else (side, side)
            for s, (cy, cx, bh, bw) in zip(scores[wi], boxes[wi]):
                if s <= self.score_thresh or not np.isfinite(s):
                    continue
                t = int(np.clip(top0 + (cy - bh / 2) * sy, 0, h))
                b = int(np.clip(top0 + (cy + bh / 2) * sy, 0, h))
                lf = int(np.clip(left0 + (cx - bw / 2) * sx, 0, w))
                r = int(np.clip(left0 + (cx + bw / 2) * sx, 0, w))
                if b > t and r > lf:
                    cands.append((float(s), (t, r, b, lf)))
        return cands

    def _merge(self, cands: List[Tuple[float, Box]],
               iou_thresh: float = 0.45) -> List[Tuple[float, Box]]:
        """Cross-window NMS on frame-coordinate boxes; with `fuse`, each kept
        detection is the score-weighted mean of its overlapping cluster
        (weighted box fusion)."""
        cands.sort(key=lambda c: -c[0])
        clusters: List[List[Tuple[float, Box]]] = []
        for s, box in cands:
            for cl in clusters:
                if _box_iou(cl[0][1], box) >= iou_thresh:
                    if self.fuse:
                        cl.append((s, box))
                    break
            else:
                if len(clusters) < self.max_faces:
                    clusters.append([(s, box)])
        out: List[Tuple[float, Box]] = []
        for cl in clusters:
            top_s = cl[0][0]
            if not self.fuse or len(cl) == 1:
                out.append((top_s, cl[0][1]))
                continue
            wsum = sum(s for s, _ in cl)
            fused = tuple(int(round(sum(s * b[i] for s, b in cl) / wsum)) for i in range(4))
            out.append((top_s, fused))  # type: ignore[arg-type]
        return out


JaxFaceDetector = DeviceFaceDetector   # the backend's name in the JAX package ('jax')


def _default_haar_downscale() -> int:
    """GENCONVIT_HAAR_DOWNSCALE, else 2 (the JAX package's production
    default: cascades on a half-resolution frame, floored at a 360 px short
    side)."""
    try:
        return max(1, int(os.environ.get("GENCONVIT_HAAR_DOWNSCALE", "2")))
    except ValueError:
        return 2


def make_detector(backend: str, device=None, **kwargs) -> FaceDetector:
    """A backend by name, as genconvit_tpu/data/faces.py `make_detector`;
    `device` places the device detector ('jax', 'hybrid')."""
    if backend in ("haar", "hybrid") and not any(
            k in kwargs for k in ("downscale", "haar_downscale")):
        kwargs["downscale"] = _default_haar_downscale()
    if backend in ("fullframe", "none"):
        return FullFrameDetector()
    if backend == "center":
        return CenterDetector(**kwargs)
    if backend == "skin":
        return SkinDetector(**kwargs)
    if backend == "haar":
        return HaarDetector(
            kwargs.get("cascade_path", os.environ.get("GENCONVIT_HAAR_CASCADE") or None),
            **{k: v for k, v in kwargs.items()
               if k in ("profile", "scale_factor", "min_neighbors",
                        "max_faces", "downscale", "front_thresh",
                        "prof_thresh", "calibrate")})
    if backend == "recorded":
        sidecar = kwargs.get("sidecar_path", os.environ.get("GENCONVIT_FACE_SIDECAR"))
        if not sidecar or not os.path.isfile(sidecar):
            raise FileNotFoundError(
                f"recorded backend needs a boxes sidecar (--face-sidecar / "
                f"GENCONVIT_FACE_SIDECAR); got {sidecar!r}")
        return RecordedDetector(sidecar)
    if backend == "jax":
        return DeviceFaceDetector(
            kwargs.get("checkpoint", default_facedet_checkpoint()), device=device,
            **{k: v for k, v in kwargs.items() if k in ("score_thresh", "max_faces", "fuse")})
    if backend == "hybrid":
        return HybridFaceDetector(
            kwargs.get("checkpoint", default_facedet_checkpoint()), device=device,
            **{k: v for k, v in kwargs.items()
               if k in ("haar_downscale", "downscale", "profile",
                        "scale_factor", "min_neighbors", "score_thresh",
                        "max_faces", "fuse", "fuse_weight", "fuse_iou",
                        "front_thresh", "prof_thresh", "calibrate")})
    raise ValueError(f"unknown face backend: {backend}")


def default_facedet_checkpoint() -> Optional[str]:
    """GENCONVIT_FACEDET_CKPT, else the JAX package's committed detector
    weights, read by path (genconvit_tpu/assets/facedet.gcv)."""
    env = os.environ.get("GENCONVIT_FACEDET_CKPT")
    if env:
        return env
    asset = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "genconvit_tpu", "assets", "facedet.gcv")
    return asset if os.path.isfile(asset) else None


@functools.lru_cache(maxsize=1024)
def _crop_weights(h: int, w: int, out: int) -> Tuple[np.ndarray, np.ndarray]:
    return crop_resize_weights_pair(h, w, (0, w, h, 0), out)


def crop_faces(frames, boxes_per_frame: List[List[Box]], budget: int,
               img_size: int = 224, device=None) -> torch.Tensor:
    """Crop + INTER_AREA resize of every box, as uint8 [<= budget, S, S, 3]
    on the device: frames (uint8 [F,H,W,3], numpy or a device tensor; a
    numpy stack goes to `device`, by default the card).

    The reference's budget semantics (quirk B7): every detected face in
    every frame takes a slot until `budget` faces are collected (ref
    model/pred_func.py:78-90); a box is sliced as numpy slices it, and an
    empty slice takes no slot. Each crop is resized with its own
    crop_resize_weights_pair (cv2's coupled fallback where an axis
    upscales), all crops in one crop_resize_batch, padded to the largest."""
    x = (frames if isinstance(frames, torch.Tensor) else
         torch.from_numpy(np.ascontiguousarray(frames)).to(
             device if device is not None else default_device()))
    h, w = x.shape[1:3]
    picks = []   # (frame, top, bottom, left, right)
    for fi, boxes in zip(range(len(x)), boxes_per_frame):
        for (top, right, bottom, left) in boxes:
            if len(picks) >= budget:
                break
            t, b, _ = slice(top, bottom).indices(h)
            lf, r, _ = slice(left, right).indices(w)
            if b <= t or r <= lf:
                continue
            picks.append((fi, t, b, lf, r))
    if not picks:
        return torch.zeros((0, img_size, img_size, 3), dtype=torch.uint8, device=x.device)
    hm = max(b - t for _, t, b, _, _ in picks)
    wm = max(r - lf for _, _, _, lf, r in picks)
    crops = torch.zeros((len(picks), hm, wm, 3), dtype=torch.float32, device=x.device)
    wh = np.zeros((len(picks), hm, img_size), np.float32)
    ww = np.zeros((len(picks), wm, img_size), np.float32)
    for k, (fi, t, b, lf, r) in enumerate(picks):
        crops[k, : b - t, : r - lf] = x[fi, t:b, lf:r]
        wh[k, : b - t], ww[k, : r - lf] = _crop_weights(b - t, r - lf, img_size)
    out = crop_resize_batch(crops, torch.from_numpy(wh), torch.from_numpy(ww))
    return round_to_u8(out)
