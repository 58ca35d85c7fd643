"""The port's face backends against the JAX package's on the CPU, on drawn
faces (a skin-toned ellipse with eyes, brows, nose and mouth, which both the
cascades and the trained detector fire on): the host backends (haar over
the same native shim, skin, center, fullframe, recorded) give equal boxes,
hybrid's within 2 px (its device detector's windows may differ from cv2's
by 1 LSB), make_detector's defaults and the Predictor's backend ladder pick
the same detector as the JAX Predictor for every face_backend, with and
without the haar shim and the detector's checkpoint."""

import json
import os

import cv2
import numpy as np
import pytest

from genconvit_tpu.data import faces as jax_faces
from genconvit_tpu.data import native as jax_native
from genconvit_tpu.infer import engine as jax_engine

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.data import faces, native
from genconvit_tpu_torch.infer import engine
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, ed_state_dict, jax_trees,
                                   small_backbone, vae_state_dict)

_ = small_backbone  # fixture
BOX_PX = 2


def _haar_available():
    return (jax_native.load_facedet_lib() is not None
            and jax_faces._find_cascade("haarcascade_frontalface_default.xml"))


needs_haar = pytest.mark.skipif(not _haar_available(),
                                reason="native haar shim or system cascades missing")


def drawn_faces(seed, n, hw):
    rng = np.random.default_rng(seed)
    h, w = hw
    out = []
    for _ in range(n):
        img = cv2.resize(rng.integers(60, 120, (6, 8, 3), np.uint8), (w, h))
        s = int(min(h, w) * rng.uniform(0.3, 0.6))
        cy, cx = h // 2 + int(rng.integers(-h // 12, h // 12)), w // 2 + int(rng.integers(-w // 8, w // 8))
        cv2.ellipse(img, (cx, cy), (int(s * 0.42), int(s * 0.55)), 0, 0, 360, (200, 160, 140), -1)
        ex, ey, lw = int(s * 0.17), int(s * 0.12), max(2, s // 40)
        for dx in (-ex, ex):
            cv2.ellipse(img, (cx + dx, cy - ey), (int(s * 0.09), int(s * 0.05)), 0, 0, 360,
                        (40, 30, 30), -1)
            cv2.line(img, (cx + dx - int(s * 0.1), cy - ey - int(s * 0.1)),
                     (cx + dx + int(s * 0.1), cy - ey - int(s * 0.1)), (60, 40, 30), lw)
        cv2.line(img, (cx, cy - int(s * 0.05)), (cx, cy + int(s * 0.12)), (150, 110, 100), lw)
        cv2.ellipse(img, (cx, cy + int(s * 0.25)), (int(s * 0.15), int(s * 0.05)), 0, 0, 360,
                    (120, 50, 50), -1)
        out.append(cv2.GaussianBlur(img, (5, 5), 2))
    return np.stack(out)


FRAME_SETS = {"480x640": (480, 640), "720x1280": (720, 1280), "360x640": (360, 640)}


@needs_haar
@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("hw", sorted(FRAME_SETS))
def test_haar_boxes_equal_jax(hw, downscale):
    frames = drawn_faces(0, 3, FRAME_SETS[hw])
    got = faces.HaarDetector(downscale=downscale).detect(frames)
    want = jax_faces.HaarDetector(downscale=downscale).detect(frames)
    assert got == want
    assert sum(map(len, want)) >= 2   # not vacuous


@needs_haar
def test_haar_legacy_mode_equals_jax():
    frames = drawn_faces(1, 2, (480, 640))
    path = jax_faces._find_cascade("haarcascade_frontalface_default.xml")
    assert faces.HaarDetector(path).detect(frames) == jax_faces.HaarDetector(path).detect(frames)


@needs_haar
@pytest.mark.parametrize("hw", sorted(FRAME_SETS))
def test_hybrid_boxes_match_jax(hw):
    frames_list = [drawn_faces(2, 2, FRAME_SETS[hw]), drawn_faces(3, 1, FRAME_SETS[hw])]
    got = faces.make_detector("hybrid", device="cpu").detect_many(frames_list)
    want = jax_faces.make_detector("hybrid").detect_many(frames_list)
    n = 0
    for gv, wv in zip(got, want):
        for gf, wf in zip(gv, wv):
            assert len(gf) == len(wf), (gf, wf)
            n += len(wf)
            for gb, wb in zip(gf, wf):
                assert max(abs(a - b) for a, b in zip(gb, wb)) <= BOX_PX, (gb, wb)
    assert n >= 3


def test_host_backends_equal_jax(tmp_path):
    frames = drawn_faces(4, 3, (360, 640))
    for name in ("skin", "center", "fullframe", "none"):
        assert (faces.make_detector(name).detect(frames)
                == jax_faces.make_detector(name).detect(frames)), name
    side = tmp_path / "boxes.json"
    side.write_text(json.dumps({"v.mp4": [[[1, 2, 3, 4], [5, 6, 7, 8]], []]}))
    got = faces.make_detector("recorded", sidecar_path=str(side)).for_video("v.mp4")
    want = jax_faces.make_detector("recorded", sidecar_path=str(side)).for_video("v.mp4")
    assert got.detect(frames) == want.detect(frames) == [[(1, 2, 3, 4), (5, 6, 7, 8)], [], []]


def test_default_checkpoint_and_make_detector_errors(monkeypatch):
    assert os.path.samefile(faces.default_facedet_checkpoint(),
                            jax_faces.default_facedet_checkpoint())
    monkeypatch.setenv("GENCONVIT_FACEDET_CKPT", "/nonexistent/facedet.gcv")
    assert faces.default_facedet_checkpoint() == "/nonexistent/facedet.gcv"
    with pytest.raises(FileNotFoundError):
        faces.make_detector("jax", device="cpu")
    monkeypatch.delenv("GENCONVIT_FACE_SIDECAR", raising=False)
    with pytest.raises(FileNotFoundError):
        faces.make_detector("recorded")
    with pytest.raises(ValueError):
        faces.make_detector("bogus")
    assert faces.JaxFaceDetector is faces.DeviceFaceDetector


@pytest.fixture(scope="module")
def small_params():
    rng = np.random.default_rng(0)
    sd_ed = ed_state_dict(0, rng)
    trees = jax_trees(sd_ed, vae_state_dict(1, rng))
    return sd_ed, trees["ed"]


_CLASS = {"JaxFaceDetector": "DeviceFaceDetector"}   # the JAX name -> the port's


@pytest.mark.parametrize("backend", ["hybrid", "jax", "haar", "fullframe", "center",
                                     "skin", "recorded", "none", "bogus"])
def test_predictor_ladder_picks_the_jax_predictors_detector(backend, small_params,
                                                            small_backbone, monkeypatch):
    sd_ed, tree_ed = small_params
    monkeypatch.delenv("GENCONVIT_FACE_SIDECAR", raising=False)
    cfg = Config(model=ModelConfig(backbone=small_backbone), img_size=IMG)
    jcfg = jax_engine.Config()
    jcfg.img_size = IMG
    for shim in (True, False):
        for ckpt in (True, False):
            with monkeypatch.context() as m:
                if not shim:
                    m.setattr(jax_native, "load_facedet_lib", lambda: None)
                    m.setattr(native, "load_facedet_lib", lambda: None)
                if not ckpt:
                    m.setenv("GENCONVIT_FACEDET_CKPT", "/nonexistent/facedet.gcv")
                want = jax_engine.Predictor(jcfg, net="ed", params={"ed": tree_ed},
                                            face_backend=backend).detector
                got = engine.Predictor(cfg, net="ed", device="cpu", params={"ed": sd_ed},
                                       face_backend=backend, kernel_plan=KernelPlan(),
                                       backbone_classes=BACKBONE_CLASSES).detector
            name = type(want).__name__
            assert type(got).__name__ == _CLASS.get(name, name), (backend, shim, ckpt)
