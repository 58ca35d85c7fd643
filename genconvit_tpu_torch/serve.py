"""Serving endpoint of the PyTorch/CUDA port (the repository's `serve.py`,
the same flags plus --device):

    python -m genconvit_tpu_torch.serve [--port 8787] [--net genconvit] [--f 15]
        [--fp16] [--face-backend B] [--weights-dir D] [--batcher staged|micro|none]
        [--batch-window-ms MS] [--max-batch N] [--decode-workers N] [--device cuda|cpu]
    curl -s -X POST --data-binary @video.mp4 localhost:8787/predict
    -> {"pred_label": "FAKE", "pred": 0.93, "y": 0, "num_frames": 15, "faces_found": 15}

POST a video to /predict for its REAL/FAKE verdict; GET /healthz for
liveness and /statz for the launch accounting. The model stays resident on
the card (--device cpu runs the plain float32 path on the CPU). Requests
flow through the staged pipeline by default (infer/serve_pipeline.py:
shared decode pool, greedy drain, one detect and one launch per drain);
`--batcher micro` takes the window-based MicroBatcher, `--batcher none`
one request at a time under a lock.

The JAX server warms every power-of-two batch bucket at start, since each
batch shape is an XLA compile; the port launches exactly the drained rows
and warms once at --max-batch, so that the first request does not wait for
the kernels to build.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from genconvit_tpu_torch.infer.aggregate import real_or_fake

log = logging.getLogger("genconvit_tpu_torch.serve")

MAX_BODY = 1 << 30


def make_handler(predictor, num_frames: int, batcher=None, pipeline=None):
    """pipeline: infer.serve_pipeline.StagedPipeline; batcher:
    infer.batcher.MicroBatcher (device batching only). With neither,
    requests take the card one at a time under a lock."""
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/statz":
                # how many launches served how many videos
                src = pipeline or batcher
                if src is not None:
                    self._reply(200, {
                        "mode": "staged" if pipeline is not None else "micro-batched",
                        "device_launches": src.launches,
                        "videos_scored": src.batched_videos})
                else:
                    self._reply(200, {"mode": "lock-serialized"})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": "unknown path"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > MAX_BODY:
                self._reply(400, {"error": "missing or oversized body"})
                return
            data = self.rfile.read(length)
            suffix = ".avi" if "avi" in (self.headers.get("Content-Type") or "") else ".mp4"
            tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
            try:
                tmp.write(data)
                tmp.close()
                if pipeline is not None:
                    y, y_val, faces_found = pipeline.submit(tmp.name)
                else:
                    faces = predictor.extract_faces(tmp.name, num_frames)
                    faces_found = int(len(faces))
                    if batcher is not None:
                        y, y_val = batcher.submit(faces)
                    else:
                        with lock:
                            y, y_val = predictor.predict_faces(faces, num_frames)
                self._reply(200, {
                    "pred_label": real_or_fake(y),
                    "pred": round(float(y_val), 6),
                    "y": int(y),
                    "num_frames": num_frames,
                    "faces_found": faces_found,
                })
            except Exception as e:  # per-request fault tolerance
                log.error("predict failed: %s", e)
                self._reply(500, {"error": str(e)})
            finally:
                os.unlink(tmp.name)

        def log_message(self, fmt, *args):
            log.info("%s %s", self.address_string(), fmt % args)

    return Handler


def gen_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("GenConViT serving (PyTorch/CUDA)")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--net", choices=["ed", "vae", "genconvit"], default="genconvit")
    p.add_argument("--f", type=int, default=15)
    p.add_argument("--fp16", action="store_true")
    p.add_argument("--face-backend", default=None)
    p.add_argument("--weights-dir", default="weight")
    p.add_argument("--batcher", choices=["staged", "micro", "none"], default="staged",
                   help="staged = the staged pipeline (default); micro = window-based "
                        "device batching; none = one request at a time")
    p.add_argument("--batch-window-ms", type=float, default=None,
                   help="straggler window: micro default 8 ms, staged default 0 "
                        "(greedy drain); 0 with --batcher micro selects 'none'")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--decode-workers", type=int, default=None,
                   help="staged decode pool size (default 2x cores, <= 8)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def build(args: argparse.Namespace):
    """(predictor, batcher, pipeline, mode) for the parsed flags, warm."""
    from genconvit_tpu_torch.config import load_config
    from genconvit_tpu_torch.infer.engine import Predictor

    config = load_config()
    config.weight_dir = args.weights_dir
    predictor = Predictor(config, net=args.net, fp16=args.fp16,
                          face_backend=args.face_backend, device=args.device)
    mode = args.batcher
    if mode == "micro" and args.batch_window_ms == 0:
        mode = "none"  # the JAX server's `--batch-window-ms 0` meaning
    s = config.img_size
    v = args.max_batch if mode in ("staged", "micro") else 1
    # one forward at the widest launch: builds the kernels before the first request
    predictor.predict_videos_batched(np.zeros((v, args.f, s, s, 3), np.uint8),
                                     np.ones((v, args.f), np.float32))
    batcher = pipeline = None
    if mode == "staged":
        from genconvit_tpu_torch.infer.serve_pipeline import StagedPipeline

        pipeline = StagedPipeline(predictor, args.f, max_batch=args.max_batch,
                                  decode_workers=args.decode_workers,
                                  window_ms=args.batch_window_ms or 0.0)
    elif mode == "micro":
        from genconvit_tpu_torch.infer.batcher import MicroBatcher

        batcher = MicroBatcher(predictor, args.f,
                               window_ms=8.0 if args.batch_window_ms is None
                               else args.batch_window_ms,
                               max_batch=args.max_batch)
    return predictor, batcher, pipeline, mode


def main(argv: Optional[List[str]] = None) -> None:
    args = gen_parser().parse_args(argv)
    predictor, batcher, pipeline, mode = build(args)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(predictor, args.f, batcher, pipeline))
    log.info("model warm; serving on %s:%d (batcher=%s, device %s)",
             args.host, server.server_port, mode, predictor.device)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        for stage in (batcher, pipeline):
            if stage is not None:
                stage.close()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
