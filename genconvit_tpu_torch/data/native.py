"""ctypes bindings of the repository's native libraries, loaded by path when
they exist (copy of the decode and face-detection halves of
genconvit_tpu/data/native.py):

  native/libgcvdecode.so   FFmpeg decoder (native/gcv_decode.cc, built by
                           `make -C native`; `GENCONVIT_NATIVE_LIB` names
                           another copy);
  native/libgcvfacedet.so  OpenCV 4 Haar-cascade shim (native/gcv_facedet.cc;
                           `GENCONVIT_FACEDET_LIB`), which needs the system's
                           OpenCV 4 C++ libraries at load.

The scaled open, the batched fullframe decoder (`decode_videos_batch`)
and the YUV reads feed drivers that are not ported yet and are left out.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATHS = (os.path.join(_NATIVE_DIR, "libgcvdecode.so"),
              os.environ.get("GENCONVIT_NATIVE_LIB", ""))

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    for p in _LIB_PATHS:
        if p and os.path.isfile(p):
            try:
                lib = ctypes.CDLL(os.path.abspath(p))
            except OSError:
                continue
            lib.gcv_open.restype = ctypes.c_void_p
            lib.gcv_open.argtypes = [ctypes.c_char_p]
            lib.gcv_num_frames.restype = ctypes.c_longlong
            lib.gcv_num_frames.argtypes = [ctypes.c_void_p]
            lib.gcv_frame_size.restype = ctypes.c_int
            lib.gcv_frame_size.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)]
            lib.gcv_read_frames.restype = ctypes.c_int
            lib.gcv_read_frames.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte)]
            lib.gcv_close.argtypes = [ctypes.c_void_p]
            _lib = lib
            return _lib
    _load_failed = True
    return None


def native_available() -> bool:
    return _load() is not None


_facedet_lib: Optional[ctypes.CDLL] = None
_facedet_failed = False


def load_facedet_lib() -> Optional[ctypes.CDLL]:
    """The Haar-cascade shim, or None where it is absent or does not load
    (the cv2 5.x wheel removed the CascadeClassifier binding)."""
    global _facedet_lib, _facedet_failed
    if _facedet_lib is not None or _facedet_failed:
        return _facedet_lib
    p = os.environ.get("GENCONVIT_FACEDET_LIB", os.path.join(_NATIVE_DIR, "libgcvfacedet.so"))
    if os.path.isfile(p):
        try:
            lib = ctypes.CDLL(os.path.abspath(p))
        except OSError:
            lib = None
        if lib is not None:
            lib.gcv_haar_create.restype = ctypes.c_void_p
            lib.gcv_haar_create.argtypes = [ctypes.c_char_p]
            lib.gcv_haar_destroy.argtypes = [ctypes.c_void_p]
            lib.gcv_haar_detect.restype = ctypes.c_int
            lib.gcv_haar_detect.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            if hasattr(lib, "gcv_haar_detect_scored"):
                lib.gcv_haar_detect_scored.restype = ctypes.c_int
                lib.gcv_haar_detect_scored.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_double, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            _facedet_lib = lib
            return _facedet_lib
    _facedet_failed = True
    return None


class NativeVideoReader:
    """Same interface as CV2VideoReader, backed by libgcvdecode (full-size
    frames; decoding straight to the model size belongs to the fullframe
    fast path, not ported)."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native decoder not built")
        self._lib = lib
        self._h = lib.gcv_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        self.path = path
        self.num_frames = int(lib.gcv_num_frames(self._h))
        w, h = ctypes.c_int(), ctypes.c_int()
        lib.gcv_frame_size(self._h, ctypes.byref(w), ctypes.byref(h))
        self.width, self.height = w.value, h.value

    def __len__(self) -> int:
        return self.num_frames

    def read_frames(self, indices: Sequence[int]) -> np.ndarray:
        n = len(indices)
        if n == 0:
            return np.zeros((0, 0, 0, 3), dtype=np.uint8)
        out = np.empty((n, self.height, self.width, 3), dtype=np.uint8)
        idx = (ctypes.c_longlong * n)(*[int(i) for i in indices])
        got = self._lib.gcv_read_frames(
            self._h, idx, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if got < 0:
            raise IOError(f"decode failed: {self.path}")
        return out[:got]

    def close(self):
        if self._h:
            self._lib.gcv_close(self._h)
            self._h = None
