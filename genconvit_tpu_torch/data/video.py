"""Video decode (copy of genconvit_tpu/data/video.py): the native FFmpeg
reader (data/native.py, `native/libgcvdecode.so` where it is built) or
OpenCV, both loaded when a video is opened, never at import.

Both readers return RGB uint8 [F, H, W, 3] for a set of frame indices.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import numpy as np

from genconvit_tpu_torch.data.frames import sample_frame_indices

log = logging.getLogger("genconvit_tpu_torch")

VIDEO_EXTENSIONS = (".avi", ".mp4", ".mpg", ".mpeg", ".mov")


def is_video(path: str) -> bool:
    """ref: model/pred_func.py:152-155 (same extension set)."""
    return os.path.isfile(path) and path.lower().endswith(VIDEO_EXTENSIONS)


class CV2VideoReader:
    """OpenCV/FFmpeg sequential reader. Decodes every frame up to the max
    requested index (robust against broken seek tables)."""

    def __init__(self, path: str):
        import cv2

        self._cv2 = cv2
        self.path = path
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self.num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._cap = cap

    def __len__(self) -> int:
        return self.num_frames

    def read_frames(self, indices: Sequence[int]) -> np.ndarray:
        cv2 = self._cv2
        wanted = sorted(set(int(i) for i in indices))
        out = {}
        pos = 0
        cap = self._cap
        cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        max_idx = wanted[-1] if wanted else -1
        want_iter = iter(wanted)
        nxt = next(want_iter, None)
        while nxt is not None and pos <= max_idx:
            ok = cap.grab()
            if not ok:
                break
            if pos == nxt:
                ok, frame = cap.retrieve()
                if not ok:
                    break
                out[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                nxt = next(want_iter, None)
            pos += 1
        frames = [out[i] for i in indices if i in out]
        if not frames:
            return np.zeros((0, 0, 0, 3), dtype=np.uint8)
        return np.stack(frames)

    def close(self):
        self._cap.release()


def open_video(path: str, prefer_native: bool = True):
    """A reader with .num_frames and .read_frames(indices): the native one
    where its library loads, else OpenCV's."""
    if prefer_native:
        from genconvit_tpu_torch.data.native import NativeVideoReader, native_available

        if native_available():
            try:
                return NativeVideoReader(path)
            except (RuntimeError, OSError) as e:   # IOError: a file it cannot open
                log.warning("native decoder failed to open %s (%s); using OpenCV",
                            os.path.basename(path), e)
    return CV2VideoReader(path)


def _maybe_inject_fault(path: str) -> None:
    """Fault injection for resilience testing: GENCONVIT_FAULT_INJECT=<p>
    makes a fraction p of decodes raise, exercising the per-video tolerance
    path. Deterministic per path."""
    spec = os.environ.get("GENCONVIT_FAULT_INJECT")
    if not spec:
        return
    import hashlib

    h = int(hashlib.md5(path.encode()).hexdigest()[:8], 16) / 0xFFFFFFFF
    if h < float(spec):
        raise IOError(f"injected decode fault: {path}")


def extract_frames(path: str, num_frames: int = 15,
                   prefer_native: bool = True) -> np.ndarray:
    """Decode the reference's evenly-stepped frame subset. RGB uint8 [F,H,W,3]."""
    _maybe_inject_fault(path)
    reader = open_video(path, prefer_native)
    try:
        idx = sample_frame_indices(len(reader), num_frames)
        return reader.read_frames(idx)
    finally:
        reader.close()
