"""Staged serving pipeline (port of genconvit_tpu/infer/serve_pipeline.py:
51-211), the serving analog of the Predictor's grouped driver
(`predict_files_group_detect`):

  stage 1 (shared pool)  each accepted request's video is decoded (the
                         module-level `infer.engine.extract_frames`, looked
                         up when called, so that a caller may substitute
                         it) and its frames go to the device once;
  stage 2 (worker)       decoded requests are drained greedily: whatever is
                         ready, up to max_batch, with no window by default;
  stage 3 (worker)       ONE detect_many call for the whole drain, from the
                         frames on the device (or the recorded boxes);
  stage 4 (worker)       crop_faces on the device from the same copy, then
                         ONE launch of exactly the drained videos (the JAX
                         pipeline pads a drain to a power-of-two bucket so
                         that XLA compiles once per bucket; eager PyTorch
                         has nothing to compile) and one fetch.

While the worker scores drain i, the pool decodes drain i+1's requests.
Errors are per request; a failed drain reaches every waiter in it; close()
lets the requests already accepted finish.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from genconvit_tpu_torch.data.faces import crop_faces
from genconvit_tpu_torch.data.preprocess import pad_faces
from genconvit_tpu_torch.infer import engine
from genconvit_tpu_torch.infer.aggregate import DEFAULT_VERDICT


class _Req:
    __slots__ = ("path", "frames", "device_frames", "event", "result", "error",
                 "faces_found")

    def __init__(self, path: str):
        self.path = path
        self.frames: Optional[np.ndarray] = None
        self.device_frames: Optional[torch.Tensor] = None
        self.event = threading.Event()
        self.result: Optional[Tuple[int, float]] = None
        self.error: Optional[BaseException] = None
        self.faces_found = 0


class StagedPipeline:
    """Accepts video paths, returns (y, y_val, faces_found) per request.

    submit() blocks the calling (request handler) thread until the verdict
    is ready; decode, detect and launch run in the shared stages above."""

    def __init__(self, predictor, num_frames: int, *, max_batch: int = 8,
                 decode_workers: Optional[int] = None, window_ms: float = 0.0):
        self.predictor = predictor
        self.num_frames = num_frames
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.launches = 0        # observability (serve.py /statz)
        self.batched_videos = 0
        self._ready: List[_Req] = []
        self._cv = threading.Condition()
        self._closed = False     # no new requests
        self._stop = False       # the pool is drained: the worker may stop
        self._pool = cf.ThreadPoolExecutor(
            max_workers=decode_workers or min(8, 2 * (os.cpu_count() or 1)),
            thread_name_prefix="gcv-decode")
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="gcv-staged-batcher")
        self._worker.start()

    # ------------------------------------------------------------- request

    def submit(self, path: str, timeout: float = 600.0) -> Tuple[int, float, int]:
        req = _Req(path)
        with self._cv:
            if self._closed:
                raise RuntimeError("StagedPipeline is closed")
            self._pool.submit(self._decode, req)
        if not req.event.wait(timeout):
            raise TimeoutError("staged prediction timed out")
        if req.error is not None:
            raise req.error
        return req.result[0], req.result[1], req.faces_found

    # -------------------------------------------------------------- stages

    def _decode(self, req: _Req) -> None:
        """Stage 1: decode and upload in the shared pool, then mark ready."""
        p = self.predictor
        try:
            with p.timers.stage("decode"):
                req.frames = engine.extract_frames(req.path, self.num_frames,
                                                   p.prefer_native_decode)
            if req.frames.size:
                req.device_frames = p._upload(req.frames)
        except Exception as e:  # per-request fault tolerance
            req.error = e
        with self._cv:
            self._ready.append(req)
            self._cv.notify()

    def _take_batch(self) -> Optional[List[_Req]]:
        with self._cv:
            while not self._ready and not self._stop:
                self._cv.wait()
            if not self._ready:
                return None  # closed and drained
        if self.window_s > 0:  # opt-in straggler window (default off)
            time.sleep(self.window_s)
        with self._cv:
            batch = self._ready[: self.max_batch]
            del self._ready[: len(batch)]
        return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._process(batch)
            except Exception as e:  # the failed drain reaches every waiter
                for r in batch:
                    if not r.event.is_set():
                        r.error = e
                        r.event.set()

    def _process(self, batch: List[_Req]) -> None:
        p = self.predictor
        s = p.config.img_size
        det_items: List[_Req] = []
        for r in batch:
            if r.error is not None:
                r.event.set()
            elif r.frames.size == 0:
                r.result = DEFAULT_VERDICT  # zero frames: (0, 0.5) (B2)
                r.event.set()
            else:
                det_items.append(r)
        if not det_items:
            return
        with p.timers.stage("detect"):   # stage 3: ONE detect for the whole drain
            boxes_list = p._detect_group([r.path for r in det_items],
                                         [r.frames for r in det_items],
                                         [r.device_frames for r in det_items])
        faces, masks, keep = [], [], []
        with p.timers.stage("crop"):
            for r, boxes in zip(det_items, boxes_list):
                crops = crop_faces(r.device_frames, boxes, self.num_frames, s)
                r.frames = r.device_frames = None  # free the full-size frames early
                r.faces_found = int(len(crops))
                if len(crops) == 0:
                    r.result = DEFAULT_VERDICT
                    r.event.set()
                    continue
                f, m = pad_faces(crops, self.num_frames, s)
                faces.append(f)
                masks.append(m)
                keep.append(r)
        if not keep:
            return
        rows = p._launch(faces, masks, len(keep))   # stage 4: ONE launch, one fetch
        with p.timers.stage("device_forward"):
            rows = rows.cpu().numpy()
        self.launches += 1
        self.batched_videos += len(keep)
        for i, r in enumerate(keep):
            r.result = (int(rows[0, i]), float(rows[1, i]))
            r.event.set()

    def close(self) -> None:
        """Refuse new requests, let the accepted ones finish, stop."""
        with self._cv:
            self._closed = True
        self._pool.shutdown(wait=True)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=60)
