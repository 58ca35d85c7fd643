"""Dataset walkers (copy of genconvit_tpu/infer/walkers.py over the port's
Predictor): directory traversal and ground-truth wiring for sample dirs,
DFDC, FaceForensics++, DeepfakeTIMIT and Celeb-DF, with the reference's
label rules (ref prediction.py:12-228).

Quirk B8 kept: the timit walker labels everything FAKE. Per-video failures
are tolerated and logged, as the reference's try/except-and-continue.
v2_labels=True switches the walkers whose v2-CLI label rules differ from
v1's to the v2 heuristics (ref prediction_v2.py:68, :185, :223-232).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

from genconvit_tpu_torch.data.video import is_video
from genconvit_tpu_torch.infer.aggregate import DEFAULT_VERDICT, real_or_fake
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.infer.result import set_result, store_result

log = logging.getLogger("genconvit_tpu_torch")


class WalkState:
    """Accumulates results + running accuracy + v2 metric vectors."""

    def __init__(self):
        self.result = set_result()
        self.count = 0
        self.correct = 0
        self.has_labels = False
        self.y_true: List[int] = []
        self.y_pred: List[int] = []

    def record(self, path: str, verdict: Optional[Tuple[int, float]], klass: str,
               correct_label: str = "unknown", compression: Optional[str] = None):
        if verdict is None:
            verdict = DEFAULT_VERDICT
        y, y_val = verdict
        self.count += 1
        store_result(self.result, os.path.basename(path), y, y_val, klass,
                     correct_label, compression)
        pred_label = real_or_fake(y)
        if correct_label in ("REAL", "FAKE"):
            self.has_labels = True
            self.y_true.append(1 if correct_label == "FAKE" else 0)
            self.y_pred.append(1 if pred_label == "FAKE" else 0)
            if correct_label == pred_label:
                self.correct += 1
            # running accuracy over LABELED videos only
            log.info("%d %s: %s %.4f  [%s]  %d/%d", self.count, os.path.basename(path),
                     pred_label, y_val, correct_label, self.correct,
                     len(self.y_true))
        else:
            log.info("%d %s: %s %.4f", self.count, os.path.basename(path),
                     pred_label, y_val)


def _process_shard(items: List) -> List:
    """GENCONVIT_PROCESS_SHARD='i/n' round-robins the video list across
    hosts (merge the result JSONs afterwards)."""
    spec = os.environ.get("GENCONVIT_PROCESS_SHARD")
    if not spec:
        return items
    pi, pc = (int(v) for v in spec.split("/"))
    return [it for idx, it in enumerate(items) if idx % pc == pi]


def _predict_all(predictor: Predictor, items: List[Tuple[str, str, str, Optional[str]]],
                 num_frames: int, state: WalkState, workers: int = 8) -> WalkState:
    """items: (path, klass, correct_label, compression)."""
    items = _process_shard(items)
    paths = [it[0] for it in items]
    outcomes = dict(predictor.predict_files(paths, num_frames, workers=workers))
    for path, klass, correct_label, compression in items:
        state.record(path, outcomes.get(path), klass, correct_label, compression)
    return state


def vids(predictor: Predictor, root_dir: str, num_frames: int = 15,
         workers: int = 8, v2_labels: bool = False) -> WalkState:
    """Flat directory of videos (ref prediction.py:12-47); subdirectories of
    frame images are scored too, one "video" per subdir (ref
    predicition_video_format_error.py:16-23). v2_labels: a filename
    containing 'fake' is FAKE, everything else REAL (ref prediction_v2.py:68)."""

    def gt(name: str) -> str:
        if not v2_labels:
            return "unknown"
        return "FAKE" if "fake" in name.lower() else "REAL"

    state = WalkState()
    items = []
    frame_dirs = []
    for filename in sorted(os.listdir(root_dir)):
        p = os.path.join(root_dir, filename)
        if is_video(p):
            items.append((p, "uncategorized", gt(filename), None))
        elif os.path.isdir(p) and any(
                f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
                for f in os.listdir(p)):
            frame_dirs.append(p)
        else:
            log.warning("invalid video file: %s", p)
    state = _predict_all(predictor, items, num_frames, state, workers)
    for p in frame_dirs:
        try:
            verdict = predictor.predict_frames_dir(p, num_frames)
        except Exception as e:  # per-video tolerance
            log.error("error on %s: %s", p, e)
            verdict = None
        state.record(p, verdict, "uncategorized", gt(os.path.basename(p)))
    return state


def faceforensics(predictor: Predictor, root_dir: str, num_frames: int = 15,
                  json_dir: str = "json_file", workers: int = 8,
                  include_faceshifter: bool = False,
                  v2_labels: bool = False) -> WalkState:
    """FF++ (ref prediction.py:50-104): only files listed in
    ff_file_list.json; klass from the manipulation dir; c23/c40 from the
    path. v2_labels is a no-op here (ref prediction_v2.py:126-131)."""
    del v2_labels
    ffdirs = ["DeepFakeDetection", "Deepfakes", "Face2Face", "FaceSwap",
              "NeuralTextures"]
    if include_faceshifter:
        ffdirs.append("FaceShifter")
    with open(os.path.join(json_dir, "ff_file_list.json")) as f:
        ff_file = set(json.load(f))
    state = WalkState()
    state.result["video"]["compression"] = []
    items = []
    for v_t in ["original_sequences", "manipulated_sequences"]:
        for dirpath, _, filenames in os.walk(os.path.join(root_dir, v_t)):
            parts = dirpath.split(os.path.sep)
            klass = next((d for d in ffdirs if d in parts), "original")
            label = "REAL" if klass == "original" else "FAKE"
            for filename in sorted(filenames):
                if filename not in ff_file:
                    continue
                p = os.path.join(dirpath, filename)
                if is_video(p):
                    compression = "c23" if "c23" in p else "c40"
                    items.append((p, klass, label, compression))
    return _predict_all(predictor, items, num_frames, state, workers)


def timit(predictor: Predictor, root_dir: str, num_frames: int = 15,
          workers: int = 8, v2_labels: bool = False) -> WalkState:
    """DeepfakeTIMIT (ref prediction.py:107-143). Labels everything FAKE (B8).
    v2_labels: the v2 CLI's walk of the whole tree (ref
    prediction_v2.py:217-264)."""
    state = WalkState()
    items = []
    if v2_labels:
        for dirpath, _, filenames in sorted(os.walk(root_dir)):
            parts = dirpath.split(os.path.sep)
            klass = ("low_quality" if "lower_quality" in parts
                     else "high_quality" if "higher_quality" in parts
                     else "real")
            label = "REAL" if klass == "real" else "FAKE"
            for filename in sorted(filenames):
                if filename.endswith(".mp4"):
                    p = os.path.join(dirpath, filename)
                    if is_video(p):
                        items.append((p, klass, label, None))
        return _predict_all(predictor, items, num_frames, state, workers)
    for keyword in ["higher_quality", "lower_quality"]:
        kdir = os.path.join(root_dir, keyword)
        if not os.path.isdir(kdir):
            continue
        for sub in sorted(os.listdir(kdir)):
            subdir = os.path.join(kdir, sub)
            if not os.path.isdir(subdir):
                continue
            for filename in sorted(os.listdir(subdir)):
                if filename.endswith(".avi"):
                    p = os.path.join(subdir, filename)
                    if is_video(p):
                        items.append((p, "DeepfakeTIMIT", "FAKE", None))
    return _predict_all(predictor, items, num_frames, state, workers)


def dfdc(predictor: Predictor, root_dir: str, num_frames: int = 15,
         json_dir: str = "json_file", workers: int = 8,
         v2_labels: bool = False) -> WalkState:
    """DFDC (ref prediction.py:146-189): file list from dfdc_files.json,
    labels from the dataset's metadata.json. v2_labels: a '_0.mp4' suffix
    is REAL, everything else FAKE (ref prediction_v2.py:185)."""
    with open(os.path.join(json_dir, "dfdc_files.json")) as f:
        dfdc_data = json.load(f)
    dfdc_meta: Dict[str, Any] = {}
    if not v2_labels:
        meta_path = os.path.join(root_dir, "metadata.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                dfdc_meta = json.load(f)
    state = WalkState()
    items = []
    for name in dfdc_data:
        p = os.path.join(root_dir, name)
        if is_video(p):
            if v2_labels:
                label = "REAL" if name.endswith("_0.mp4") else "FAKE"
            else:
                label = dfdc_meta.get(name, {}).get("label", "unknown")
            items.append((p, "dfdc", label, None))
    return _predict_all(predictor, items, num_frames, state, workers)


def celeb(predictor: Predictor, root_dir: str, num_frames: int = 15,
          json_dir: str = "json_file", workers: int = 8,
          v2_labels: bool = False) -> WalkState:
    """Celeb-DF v2 (ref prediction.py:192-228): list from celeb_test.json,
    class from the path prefix (Celeb-synthesis => FAKE). v2_labels is a
    no-op (ref prediction_v2.py:288)."""
    del v2_labels
    with open(os.path.join(json_dir, "celeb_test.json")) as f:
        cfl = json.load(f)
    state = WalkState()
    items = []
    for ck in cfl:
        klass = ck.split("/")[0]
        correct_label = "FAKE" if klass == "Celeb-synthesis" else "REAL"
        p = os.path.join(root_dir, ck)
        if is_video(p):
            items.append((p, klass, correct_label, None))
    return _predict_all(predictor, items, num_frames, state, workers)


WALKERS = {
    "vids": vids,
    "faceforensics": faceforensics,
    "timit": timit,
    "dfdc": dfdc,
    "celeb": celeb,
}
