"""ctypes bindings of the repository's native libraries, loaded by path when
they exist (copy of genconvit_tpu/data/native.py):

  native/libgcvdecode.so   FFmpeg decoder (native/gcv_decode.cc, built by
                           `make -C native`; `GENCONVIT_NATIVE_LIB` names
                           another copy);
  native/libgcvfacedet.so  OpenCV 4 Haar-cascade shim (native/gcv_facedet.cc;
                           `GENCONVIT_FACEDET_LIB`), which needs the system's
                           OpenCV 4 C++ libraries at load.

The decoder also opens a video scaled to the model size (swscale decodes
straight to S x S), decodes many videos in its own thread pool into one
[V,F,S,S,3] block (`decode_videos_batch`), and reads planar YUV420 with
the stream's colour space and range (`NativeVideoReader.read_frames_yuv`,
`.color_info`): the fullframe fast paths of infer/engine.py.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

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
            lib.gcv_open_scaled.restype = ctypes.c_void_p
            lib.gcv_open_scaled.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
            lib.gcv_decode_videos.restype = ctypes.c_int
            lib.gcv_decode_videos.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
            lib.gcv_color_info.restype = ctypes.c_int
            lib.gcv_color_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)]
            lib.gcv_read_frames_yuv.restype = ctypes.c_int
            lib.gcv_read_frames_yuv.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte)]
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


def decode_videos_batch(paths: Sequence[str], frames_per_video: int, out_w: int,
                        out_h: int, threads: int = 0):
    """The library's thread-pool batch decode: (frames uint8
    [V, F, out_h, out_w, 3], counts int64 [V]), each video's frames decoded
    at the target size (swscale SWS_AREA) with the reference's frame
    stepping; counts[v] == 0 marks an unreadable video."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder not built")
    n = len(paths)
    out = np.zeros((n, frames_per_video, out_h, out_w, 3), np.uint8)
    counts = np.zeros((n,), np.int64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.gcv_decode_videos(
        c_paths, n, frames_per_video, out_w, out_h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), threads)
    return out, counts


class NativeVideoReader:
    """Same interface as CV2VideoReader, backed by libgcvdecode.
    out_size=(w, h) decodes straight to that size (swscale SWS_AREA): the
    fullframe fast path's fused decode and resize."""

    def __init__(self, path: str, out_size: Optional[Tuple[int, int]] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native decoder not built")
        self._lib = lib
        if out_size:
            self._h = lib.gcv_open_scaled(path.encode(), int(out_size[0]), int(out_size[1]))
        else:
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

    def color_info(self) -> Tuple[str, bool]:
        """('bt601' | 'bt709', full_range) of the stream, for the device-side
        conversion."""
        space, rng = ctypes.c_int(), ctypes.c_int()
        self._lib.gcv_color_info(self._h, ctypes.byref(space), ctypes.byref(rng))
        return ("bt709" if space.value else "bt601"), bool(rng.value)

    def read_frames_yuv(self, indices: Sequence[int]):
        """Planar YUV420: (y [n,H,W], u [n,H/2,W/2], v [n,H/2,W/2]) uint8,
        half the bytes of RGB24 for the host-to-device copy."""
        n = len(indices)
        w, h = self.width, self.height
        ys, cs = w * h, (w // 2) * (h // 2)
        buf = np.empty((n, ys + 2 * cs), dtype=np.uint8)
        idx = (ctypes.c_longlong * n)(*[int(i) for i in indices])
        got = self._lib.gcv_read_frames_yuv(
            self._h, idx, n, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if got < 0:
            raise IOError(f"decode failed: {self.path}")
        buf = buf[:got]
        return (buf[:, :ys].reshape(got, h, w),
                buf[:, ys: ys + cs].reshape(got, h // 2, w // 2),
                buf[:, ys + cs:].reshape(got, h // 2, w // 2))

    def close(self):
        if self._h:
            self._lib.gcv_close(self._h)
            self._h = None
