"""Cross-request micro-batching for serving (port of
genconvit_tpu/infer/batcher.py:21-133).

Instead of serializing the card with a per-request lock, requests that
arrive within a small window coalesce into ONE batched launch through the
Predictor's [V,F,...] path. A request's faces stay on the device: `submit`
pads them there (`pad_faces`), the worker stacks the drained requests and
launches exactly those rows. The JAX batcher pads a drain to a power-of-two
bucket so that XLA compiles once per bucket; eager PyTorch has no compile
to save, so the port launches the drained rows as they are.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from genconvit_tpu_torch.data.preprocess import pad_faces
from genconvit_tpu_torch.infer.aggregate import DEFAULT_VERDICT


class _Pending:
    __slots__ = ("faces", "mask", "event", "result", "error")

    def __init__(self, faces: torch.Tensor, mask: torch.Tensor):
        self.faces = faces
        self.mask = mask
        self.event = threading.Event()
        self.result: Optional[Tuple[int, float]] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Collects predict requests for up to `window_ms` and scores them in one
    batched device launch.

    submit() blocks the calling (request) thread until its verdict is ready.
    The single worker thread drains the queue: it waits for the first item,
    gives the window for stragglers to join, then launches. close() lets it
    score what is queued, then stops it.
    """

    def __init__(self, predictor, num_frames: int, *, window_ms: float = 8.0,
                 max_batch: int = 8):
        self.predictor = predictor
        self.num_frames = num_frames
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.launches = 0          # observability: device launches issued
        self.batched_videos = 0    # videos scored through those launches
        self._queue: List[_Pending] = []
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="gcv-microbatcher")
        self._worker.start()

    # ------------------------------------------------------------- request

    def submit(self, faces, timeout: float = 120.0) -> Tuple[int, float]:
        """faces: [k,S,S,3] uint8 on the device (as extract_faces returns
        them; a numpy array is uploaded), k in [0, num_frames]. Blocks until
        the batched verdict for this video is available."""
        if len(faces) == 0:
            return DEFAULT_VERDICT  # no device trip (ref prediction.py:250-253)
        if not isinstance(faces, torch.Tensor):
            faces = torch.from_numpy(np.ascontiguousarray(faces))
        batch, mask = pad_faces(faces.to(self.predictor.device), self.num_frames,
                                self.predictor.config.img_size)
        item = _Pending(batch, mask)
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append(item)
            self._cv.notify()
        if not item.event.wait(timeout):
            raise TimeoutError("batched prediction timed out")
        if item.error is not None:
            raise item.error
        return item.result

    # ------------------------------------------------------------- worker

    def _take_batch(self) -> Optional[List[_Pending]]:
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue:
                return None  # closed and drained
        # the window: let concurrent requests pile in (outside the lock so
        # submitters aren't blocked), then take up to max_batch
        if self.window_s > 0:
            time.sleep(self.window_s)
        with self._cv:
            batch = self._queue[: self.max_batch]
            del self._queue[: len(batch)]
        return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                rows = self.predictor._launch([it.faces for it in batch],
                                              [it.mask for it in batch], len(batch))
                rows = rows.cpu().numpy()
            except Exception as e:  # the failed launch reaches every waiter
                for it in batch:
                    it.error = e
                    it.event.set()
                continue
            self.launches += 1
            self.batched_videos += len(batch)
            for i, it in enumerate(batch):
                it.result = (int(rows[0, i]), float(rows[1, i]))
                it.event.set()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=60)
