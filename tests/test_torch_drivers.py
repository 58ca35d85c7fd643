"""The video-to-verdict path of the port against the JAX package's on the
CPU: both Predictors load the same `.gcv` files, written by the JAX
package's save_checkpoint (the small backbone of test_torch_util, 64 px,
float32, deterministic VAE, the heads' last layer scaled so that verdicts
are decisive), and score the same mp4s written by cv2.VideoWriter, frame
directories and CLI runs. Verdicts: y_val within 2e-3 (the face crops differ
from cv2's by at most 1 LSB) and equal labels where |y_val - 0.5| > 1e-2."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from genconvit_tpu.config import Config as JaxConfig
from genconvit_tpu.core import checkpoint as jax_ckpt
from genconvit_tpu.infer import engine as jax_engine

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.infer import engine
from genconvit_tpu_torch.infer.aggregate import DEFAULT_VERDICT
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
from genconvit_tpu_torch import prediction as port_cli

from tests.test_torch_util import (IMG, ed_state_dict, jax_trees, small_backbone,
                                   vae_state_dict)

_ = small_backbone  # fixture
FRAMES = 4
YVAL_TOL = 2e-3
LABEL_MARGIN = 1e-2
HEAD_SCALE = 10.0   # the heads' last layer, scaled so that verdicts leave 0.5
FRAME_HW = (96, 128)
# (t, r, b, l) boxes on the 96 x 128 frames: downscaled on both axes, one
# axis up and one down (cv2's coupled fallback), both up, a frame edge
BOXES = ([0, 128, 96, 0], [10, 90, 50, 20], [5, 40, 30, 10], [60, 128, 96, 70])


def _write_video(path, seed, n_frames=12, hw=FRAME_HW):
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 12, (hw[1], hw[0]))
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (hw[0] // 8, hw[1] // 8, 3), np.uint8)
    for i in range(n_frames):
        frame = cv2.resize(base, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
        frame = np.clip(frame.astype(np.int32) + 9 * i - 40, 0, 255).astype(np.uint8)
        frame[20:70, 30:100] = rng.integers(0, 255, (50, 70, 3), np.uint8)
        vw.write(frame)
    vw.release()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Weights (.gcv by the JAX package's writer, nested as train_model
    nests them), four videos, an unreadable one, a frames directory and a
    recorded-boxes sidecar (up to two boxes a frame, quirk B7; none for the
    zero-face video)."""
    import cv2

    root = tmp_path_factory.mktemp("drivers")
    rng = np.random.default_rng(0)
    sd_ed, sd_vae = ed_state_dict(0, rng), vae_state_dict(1, rng)
    for sd in (sd_ed, sd_vae):
        sd["fc2.weight"] *= HEAD_SCALE
        sd["fc2.bias"] *= HEAD_SCALE
    trees = jax_trees(sd_ed, sd_vae)
    wdir = root / "weights"
    jax_ckpt.save_checkpoint(str(wdir / "genconvit_ed_inference.gcv"), {"ed": trees["ed"]})
    jax_ckpt.save_checkpoint(str(wdir / "genconvit_vae_inference.gcv"), {"vae": trees["vae"]})
    vdir = root / "videos"
    vdir.mkdir()
    for i in range(4):
        _write_video(str(vdir / f"v{i}.mp4"), seed=10 + i)
    (vdir / "broken.mp4").write_bytes(b"not a video at all" * 8)
    fdir = vdir / "frames_a"
    fdir.mkdir()
    frng = np.random.default_rng(5)
    for i in range(6):
        img = frng.integers(0, 255, FRAME_HW + (3,), np.uint8)
        cv2.imwrite(str(fdir / f"{i:03d}.png"), img)
    sidecar = {f"v{i}.mp4": [[BOXES[(i + k) % 4]] + ([BOXES[(i + k + 1) % 4]] if k % 2 else [])
                             for k in range(FRAMES)] for i in range(3)}
    sidecar["v3.mp4"] = [[] for _ in range(FRAMES)]
    with open(root / "boxes.json", "w") as f:
        json.dump(sidecar, f)
    return {"root": root, "weights": wdir, "videos": vdir, "frames": fdir,
            "sidecar": str(root / "boxes.json")}


def _jax_predictor(corpus, backend):
    cfg = JaxConfig()
    cfg.img_size = IMG
    cfg.model.latent_dims = cfg.derived_latent_dims()
    cfg.weight_dir = str(corpus["weights"])
    return jax_engine.Predictor(cfg, net="genconvit", face_backend=backend,
                                deterministic_vae=True)


def _port_predictor(corpus, backend, backbone):
    cfg = Config(model=ModelConfig(backbone=backbone), img_size=IMG,
                 weight_dir=str(corpus["weights"]))
    return engine.Predictor(cfg, device="cpu", face_backend=backend,
                            deterministic_vae=True, kernel_plan=KernelPlan())


def _same_verdict(got, want, what):
    assert (got is None) == (want is None), what
    if want is None:
        return
    assert abs(got[1] - want[1]) <= YVAL_TOL, (what, got, want)
    if abs(want[1] - 0.5) > LABEL_MARGIN:
        assert got[0] == want[0], (what, got, want)


@pytest.fixture
def sidecar_env(corpus, monkeypatch):
    monkeypatch.setenv("GENCONVIT_FACE_SIDECAR", corpus["sidecar"])


@pytest.mark.parametrize("backend", ["center", "fullframe", "recorded"])
def test_predict_video_matches_jax(corpus, sidecar_env, small_backbone, backend):
    jp = _jax_predictor(corpus, backend)
    pp = _port_predictor(corpus, backend, small_backbone)
    decisive = 0
    for i in range(4):
        path = str(corpus["videos"] / f"v{i}.mp4")
        want, got = jp.predict_video(path, FRAMES), pp.predict_video(path, FRAMES)
        _same_verdict(got, want, (backend, path))
        decisive += abs(want[1] - 0.5) > LABEL_MARGIN
    assert decisive >= 2   # the label check is not vacuous
    assert set(pp.timers.summary()) >= {"decode", "detect", "crop", "device_forward"}


@pytest.mark.parametrize("backend", ["center", "recorded"])
def test_predict_files_matches_jax(corpus, sidecar_env, small_backbone, backend):
    """Grouped (detector) driver with a ragged tail, an unreadable file
    (None) and, under 'recorded', a zero-face video (the default verdict)."""
    paths = [str(corpus["videos"] / n) for n in
             ("v0.mp4", "broken.mp4", "v1.mp4", "v2.mp4", "v3.mp4")]
    want = dict(_jax_predictor(corpus, backend).predict_files(paths, FRAMES, workers=2,
                                                              video_batch=2))
    pp = _port_predictor(corpus, backend, small_backbone)
    got = dict(pp.predict_files(paths, FRAMES, workers=2, video_batch=2))
    assert list(got) == paths
    assert got[paths[1]] is None
    if backend == "recorded":
        assert got[paths[4]] == want[paths[4]] == DEFAULT_VERDICT
    for p in paths:
        _same_verdict(got[p], want[p], (backend, p))


def test_predict_files_generic_driver_matches_jax(corpus, small_backbone, monkeypatch):
    """GENCONVIT_GROUP_DETECT=0 takes the thread-pool driver of extract_faces."""
    monkeypatch.setenv("GENCONVIT_GROUP_DETECT", "0")
    paths = [str(corpus["videos"] / n) for n in ("v0.mp4", "broken.mp4", "v2.mp4")]
    want = dict(_jax_predictor(corpus, "center").predict_files(paths, FRAMES, workers=2,
                                                               video_batch=2))
    got = dict(_port_predictor(corpus, "center", small_backbone).predict_files(
        paths, FRAMES, workers=2, video_batch=2))
    for p in paths:
        _same_verdict(got[p], want[p], p)


def test_recorded_verdicts_equal_predict_faces_on_the_crops(corpus, sidecar_env,
                                                             small_backbone):
    """The grouped driver's verdict of each video is predict_faces on the
    same crops (float32 on the CPU: the same arithmetic, batch aside)."""
    from genconvit_tpu_torch.data.faces import crop_faces
    from genconvit_tpu_torch.data.video import extract_frames

    pp = _port_predictor(corpus, "recorded", small_backbone)
    paths = [str(corpus["videos"] / f"v{i}.mp4") for i in range(3)]
    got = dict(pp.predict_files(paths, FRAMES, workers=2, video_batch=4))
    for p in paths:
        frames = extract_frames(p, FRAMES)
        boxes = pp.detector.for_video(os.path.basename(p)).detect(frames)
        want = pp.predict_faces(crop_faces(frames, boxes, FRAMES, IMG, device="cpu"), FRAMES)
        assert got[p][0] == want[0]
        assert abs(got[p][1] - want[1]) <= 1e-5


def test_predict_frames_dir_matches_jax(corpus, small_backbone):
    want = _jax_predictor(corpus, "center").predict_frames_dir(str(corpus["frames"]), FRAMES)
    got = _port_predictor(corpus, "center", small_backbone).predict_frames_dir(
        str(corpus["frames"]), FRAMES)
    _same_verdict(got, want, "frames dir")


def test_cli_result_matches_root_prediction(corpus, small_backbone, tmp_path, monkeypatch):
    """The port's CLI and the repository's prediction.py on the same
    directory (config from ./model/config.yaml, which both read): the same
    result keys, names and labels."""
    (tmp_path / "model").mkdir()
    (tmp_path / "model" / "config.yaml").write_text(
        f"model:\n  backbone: {small_backbone}\n  latent_dims: {256 * (IMG // 32) ** 2}\n"
        f"img_size: {IMG}\nnum_classes: 2\n")
    monkeypatch.chdir(tmp_path)
    common = ["--p", str(corpus["videos"]), "--f", str(FRAMES), "--face-backend", "center",
              "--weights-dir", str(corpus["weights"]), "--deterministic-vae",
              "--workers", "2"]
    out_port = port_cli.main(common + ["--result-dir", str(tmp_path / "port"),
                                       "--device", "cpu"])
    import prediction as root_cli

    monkeypatch.setattr(sys, "argv", ["prediction.py"] + common
                        + ["--result-dir", str(tmp_path / "jax")])
    root_cli.main()
    (out_jax,) = [os.path.join(tmp_path / "jax", f) for f in os.listdir(tmp_path / "jax")]
    with open(out_port) as f:
        got = json.load(f)
    with open(out_jax) as f:
        want = json.load(f)
    assert set(got) == set(want) and set(got["video"]) == set(want["video"])
    assert got["video"]["name"] == want["video"]["name"]
    assert len(got["video"]["name"]) == 6   # 4 videos, the broken one, the frames dir
    assert set(got["metadata"]) == set(want["metadata"])
    for i, name in enumerate(want["video"]["name"]):
        assert abs(got["video"]["pred"][i] - want["video"]["pred"][i]) <= YVAL_TOL, name
        if abs(want["video"]["pred"][i] - 0.5) > LABEL_MARGIN:
            assert got["video"]["pred_label"][i] == want["video"]["pred_label"][i], name


def test_cli_refuses_yuv420(corpus):
    with pytest.raises(NotImplementedError, match="yuv420"):
        port_cli.main(["--p", str(corpus["videos"]), "--transfer-format", "yuv420"])


def test_native_fullframe_path_is_refused(corpus, small_backbone, monkeypatch):
    """Where the native decoder loads, fullframe + prefer_native_decode is
    the JAX engine's fast path, not ported: the port raises, it does not
    take the generic path."""
    from genconvit_tpu_torch.data import native

    pp = _port_predictor(corpus, "fullframe", small_backbone)
    monkeypatch.setattr(native, "native_available", lambda: True)
    path = str(corpus["videos"] / "v0.mp4")
    with pytest.raises(NotImplementedError, match="fast path"):
        pp.predict_video(path, FRAMES)
    with pytest.raises(NotImplementedError, match="fast path"):
        pp.predict_files([path, path], FRAMES)
    pp.prefer_native_decode = False
    assert pp.predict_video(path, FRAMES) != DEFAULT_VERDICT


def test_extract_frames_is_looked_up_when_called(corpus, small_backbone, monkeypatch):
    """The drivers decode through engine.extract_frames at call time (a
    caller may substitute an in-memory source); a decode error is that
    video's None."""
    pp = _port_predictor(corpus, "center", small_backbone)
    rng = np.random.default_rng(1)
    frames = {"a.mp4": rng.integers(0, 256, (FRAMES,) + FRAME_HW + (3,), np.uint8),
              "b.mp4": np.zeros((0, 0, 0, 3), np.uint8)}

    def fake(path, num_frames, prefer_native=True):
        if path not in frames:
            raise IOError(f"no such video {path}")
        return frames[path]

    monkeypatch.setattr(engine, "extract_frames", fake)
    got = dict(pp.predict_files(["a.mp4", "b.mp4", "c.mp4"], FRAMES, workers=2))
    assert got["b.mp4"] == DEFAULT_VERDICT and got["c.mp4"] is None
    assert got["a.mp4"] == pp.predict_video("a.mp4", FRAMES)


def test_weights_by_name_random_init_warns_and_params_must_be_whole(corpus, small_backbone,
                                                                    tmp_path, caplog):
    """ed_weight/vae_weight resolve as the JAX engine resolves them; a
    branch whose file is not found runs seeded random weights with the JAX
    engine's warning; explicit params lacking a branch are refused."""
    import shutil

    wdir = tmp_path / "w"
    wdir.mkdir()
    shutil.copy(corpus["weights"] / "genconvit_ed_inference.gcv", wdir / "mine.gcv")
    cfg = Config(model=ModelConfig(backbone=small_backbone), img_size=IMG, weight_dir=str(wdir))
    with caplog.at_level("WARNING", logger="genconvit_tpu_torch"):
        pp = engine.Predictor(cfg, device="cpu", ed_weight="mine", face_backend="center",
                              kernel_plan=KernelPlan())
    assert "no vae weights found" in caplog.text and "RANDOM" in caplog.text
    assert "no ed weights found" not in caplog.text
    loaded = _port_predictor(corpus, "center", small_backbone).state_dicts()["ed"]
    for k, v in pp.state_dicts()["ed"].items():
        assert torch.equal(v, loaded[k]), k
    with pytest.raises(KeyError, match="needs"):
        engine.Predictor(cfg, device="cpu", params={"ed": loaded}, face_backend="center",
                         kernel_plan=KernelPlan())
