"""The fullframe fast paths of the port against the JAX package's on the
CPU: the native decoder's bindings, `extract_faces` decoding straight to
the model size, `predict_files` through `predict_files_native_rgb` and,
under transfer_format='yuv420', `predict_files_yuv`, both prediction CLIs
with `--face-backend fullframe --transfer-format yuv420`, and a fullframe
server. Both Predictors load test_torch_drivers' `.gcv` weights (the
small backbone of test_torch_util, 64 px, float32, deterministic VAE) and
read its mp4s.

The first group builds `native/gcv_decode.cc` with the Makefile's flags
into a temporary directory (under a second; skipped only where g++ or
FFmpeg's development files are missing) and points both packages' module
globals at it for this file alone: their library path is fixed when the
module is imported, so the environment variable would not reach it. The
second group swaps an in-memory decoder (test_torch_util.InMemoryDecoder)
into both packages, so that the drivers are held where the library cannot
be built. Verdicts: y equal, y_val within 1e-5 (the same frames or planes
reach both forwards); None and the (0, 0.5) default where JAX gives them."""

import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from genconvit_tpu.config import Config as JaxConfig
from genconvit_tpu.data import native as jax_native
from genconvit_tpu.infer import engine as jax_engine

from genconvit_tpu_torch import prediction, prediction_v2, serve
from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.data import native
from genconvit_tpu_torch.infer import engine
from genconvit_tpu_torch.infer.aggregate import DEFAULT_VERDICT
from genconvit_tpu_torch.infer.batcher import MicroBatcher
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_drivers import corpus  # noqa: F401  (module fixture)
from tests.test_torch_serve import _call, serving
from tests.test_torch_util import IMG, InMemoryDecoder, small_backbone_registered

FRAMES = 4
SAME_TOL = 1e-5
CROP_TOL = 2e-3      # the frames directory: cv2 crops on one side (test_torch_drivers)
LABEL_MARGIN = 1e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFMPEG = ("libavformat", "libavcodec", "libavutil", "libswscale")


def _toolchain() -> bool:
    if shutil.which("g++") is None or shutil.which("pkg-config") is None:
        return False
    return subprocess.run(["pkg-config", "--exists", *FFMPEG]).returncode == 0


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """libgcvdecode.so built into a temporary directory; both packages'
    loaders point at it until the module's tests are done."""
    if not _toolchain():
        pytest.skip("g++ or FFmpeg's development files (pkg-config) not found")
    out = str(tmp_path_factory.mktemp("native") / "libgcvdecode.so")
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared",
                    "-o", out, os.path.join(ROOT, "native", "gcv_decode.cc"),
                    "-lavformat", "-lavcodec", "-lavutil", "-lswscale"],
                   check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        for m in (native, jax_native):
            mp.setattr(m, "_LIB_PATHS", (out,))
            mp.setattr(m, "_lib", None)
            mp.setattr(m, "_load_failed", False)
        assert native.native_available() and jax_native.native_available()
        yield out


@pytest.fixture(scope="module")
def pair(corpus):  # noqa: F811
    """(port, JAX) fullframe Predictors on the drivers' weights."""
    with small_backbone_registered() as backbone:
        cfg = Config(model=ModelConfig(backbone=backbone), img_size=IMG,
                     weight_dir=str(corpus["weights"]))
        pp = engine.Predictor(cfg, device="cpu", face_backend="fullframe",
                              deterministic_vae=True, kernel_plan=KernelPlan())
        jcfg = JaxConfig()
        jcfg.img_size = IMG
        jcfg.model.latent_dims = jcfg.derived_latent_dims()
        jcfg.weight_dir = str(corpus["weights"])
        jp = jax_engine.Predictor(jcfg, net="genconvit", face_backend="fullframe",
                                  deterministic_vae=True)
        yield pp, jp


def _same(got, want, what, tol=SAME_TOL):
    assert (got is None) == (want is None), (what, got, want)
    if want is None:
        return
    assert abs(got[1] - want[1]) <= tol, (what, got, want)
    if tol == SAME_TOL or abs(want[1] - 0.5) > LABEL_MARGIN:
        assert got[0] == want[0], (what, got, want)


def _videos(corpus, names=("v0.mp4", "broken.mp4", "v1.mp4", "v2.mp4", "v3.mp4")):  # noqa: F811
    return [str(corpus["videos"] / n) for n in names]


@pytest.fixture
def transfer(pair, request):
    """Both Predictors under request.param's transfer format, put back after."""
    pp, jp = pair
    old = pp.transfer_format, jp.transfer_format
    pp.transfer_format = jp.transfer_format = request.param
    yield pp, jp
    pp.transfer_format, jp.transfer_format = old


# ------------------------------------------------------- with the library

def test_bindings_equal_jax(native_lib, corpus):  # noqa: F811
    """Scaled and full-size reads, planar YUV420, colour info and the
    batch decode (a broken file: count 0) give the JAX bindings' bytes."""
    path = str(corpus["videos"] / "v1.mp4")
    for out_size in (None, (IMG, IMG), (48, 32)):
        a, b = native.NativeVideoReader(path, out_size), jax_native.NativeVideoReader(
            path, out_size)
        try:
            assert (len(a), a.width, a.height) == (len(b), b.width, b.height)
            idx = [0, 3, 5, 11]
            np.testing.assert_array_equal(a.read_frames(idx), b.read_frames(idx))
            for pa, pb in zip(a.read_frames_yuv(idx), b.read_frames_yuv(idx), strict=True):
                assert pa.shape[0] == 4
                np.testing.assert_array_equal(pa, pb)
            assert a.color_info() == b.color_info()
            assert a.color_info()[0] in ("bt601", "bt709")
        finally:
            a.close()
            b.close()
    assert (a.width, a.height) == (48, 32)
    paths = _videos(corpus)
    fa, ca = native.decode_videos_batch(paths, FRAMES, IMG, IMG)
    fb, cb = jax_native.decode_videos_batch(paths, FRAMES, IMG, IMG)
    assert fa.shape == (5, FRAMES, IMG, IMG, 3) and ca.dtype == np.int64
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(fa, fb)
    assert ca[1] == 0 and (ca[[0, 2, 3, 4]] == FRAMES).all()
    with pytest.raises(IOError):
        native.NativeVideoReader(paths[1], (IMG, IMG))


def test_extract_faces_decodes_to_model_size_like_jax(native_lib, pair, corpus):  # noqa: F811
    """The fullframe branch: the scaled read, bit for bit the JAX engine's,
    with no detect or crop; predict_video within 1e-5."""
    pp, jp = pair
    detects = pp.timers.summary().get("detect", {}).get("count", 0)
    for name in ("v0.mp4", "v3.mp4"):
        path = str(corpus["videos"] / name)
        got = pp.extract_faces(path, FRAMES)
        assert got.shape == (FRAMES, IMG, IMG, 3)
        np.testing.assert_array_equal(got.numpy(), jp.extract_faces(path, FRAMES))
        _same(pp.predict_video(path, FRAMES), jp.predict_video(path, FRAMES), name)
    assert pp.timers.summary().get("detect", {}).get("count", 0) == detects
    with pytest.raises(IOError):
        pp.extract_faces(str(corpus["videos"] / "broken.mp4"), FRAMES)


@pytest.mark.parametrize("transfer", ["rgb", "yuv420"], indirect=True)
def test_predict_files_native_drivers_match_jax(native_lib, transfer, corpus,  # noqa: F811
                                                monkeypatch):
    """Several paths take predict_files_native_rgb (the broken file: count
    0, the default verdict) or predict_files_yuv (a decode error: None)."""
    pp, jp = transfer
    driver = "predict_files_yuv" if pp.transfer_format == "yuv420" else \
        "predict_files_native_rgb"
    calls = []
    real = getattr(pp, driver)
    monkeypatch.setattr(pp, driver, lambda *a, **k: calls.append(a) or real(*a, **k))
    paths = _videos(corpus)
    want = dict(jp.predict_files(paths, FRAMES, workers=2, video_batch=2))
    got = dict(pp.predict_files(paths, FRAMES, workers=2, video_batch=2))
    assert len(calls) == 1 and list(got) == paths
    assert got[paths[1]] == want[paths[1]] == (
        None if pp.transfer_format == "yuv420" else DEFAULT_VERDICT)
    decisive = 0
    for p in paths:
        _same(got[p], want[p], (pp.transfer_format, p))
        decisive += want[p] is not None and abs(want[p][1] - 0.5) > LABEL_MARGIN
    assert decisive >= 2


@pytest.mark.parametrize("cli", ["prediction", "prediction_v2"])
def test_cli_fullframe_yuv420_matches_root_cli(native_lib, corpus, tmp_path,  # noqa: F811
                                               monkeypatch, cli):
    """`--face-backend fullframe --transfer-format yuv420`: the root CLI's
    result keys, names and verdicts (the frames directory goes through
    cv2 and the fullframe crop: within 2e-3)."""
    import importlib

    (tmp_path / "model").mkdir()
    (tmp_path / "model" / "config.yaml").write_text(
        f"model:\n  backbone: convnext_test\n  latent_dims: {256 * (IMG // 32) ** 2}\n"
        f"img_size: {IMG}\nnum_classes: 2\n")
    monkeypatch.chdir(tmp_path)
    common = ["--p", str(corpus["videos"]), "--f", str(FRAMES), "--face-backend", "fullframe",
              "--transfer-format", "yuv420", "--weights-dir", str(corpus["weights"]),
              "--workers", "2"]
    port_cli = {"prediction": prediction, "prediction_v2": prediction_v2}[cli]
    root_cli = importlib.import_module(cli)
    if cli == "prediction":
        common.append("--deterministic-vae")
    else:   # no such flag: the Predictor is made deterministic
        for m in (port_cli, root_cli):
            monkeypatch.setattr(m, "Predictor", functools.partial(m.Predictor,
                                                                  deterministic_vae=True))
    seen = []
    real = engine.Predictor.predict_files_yuv
    monkeypatch.setattr(engine.Predictor, "predict_files_yuv",
                        lambda self, *a, **k: seen.append(len(a[0])) or real(self, *a, **k))
    with small_backbone_registered():
        out_port = port_cli.main(common + ["--result-dir", str(tmp_path / "port"),
                                           "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", [f"{cli}.py"] + common
                        + ["--result-dir", str(tmp_path / "jax")])
    root_cli.main()
    (out_jax,) = [os.path.join(tmp_path / "jax", f) for f in os.listdir(tmp_path / "jax")]
    with open(out_port) as f:
        got = json.load(f)
    with open(out_jax) as f:
        want = json.load(f)
    assert seen == [5]   # the five files; the frames directory is scored on its own
    assert set(got) == set(want) and set(got["video"]) == set(want["video"])
    assert set(got["metadata"]) == set(want["metadata"])
    names = got["video"]["name"]
    assert names == want["video"]["name"] and len(names) == 6
    for i, name in enumerate(names):
        tol = CROP_TOL if name.endswith("frames_a") else SAME_TOL
        _same((got["video"]["pred_label"][i], got["video"]["pred"][i]),
              (want["video"]["pred_label"][i], want["video"]["pred"][i]), name, tol)
    if cli == "prediction_v2":
        assert got["metrics"] == want["metrics"]


def test_generic_path_without_prefer_native_decode(native_lib, pair, corpus,  # noqa: F811
                                                   monkeypatch):
    """prefer_native_decode=False: the library is not touched (decode by
    cv2, the fullframe detector and crop), verdicts within 2e-3 of the JAX
    engine's generic path."""
    pp, jp = pair

    def refuse(*a, **k):
        raise AssertionError("the native decoder was used")

    monkeypatch.setattr(native, "NativeVideoReader", refuse)
    monkeypatch.setattr(native, "decode_videos_batch", refuse)
    monkeypatch.setattr(pp, "prefer_native_decode", False)
    monkeypatch.setattr(jp, "prefer_native_decode", False)
    paths = _videos(corpus, ("v0.mp4", "broken.mp4", "v2.mp4"))
    got = dict(pp.predict_files(paths, FRAMES, workers=2, video_batch=2))
    want = dict(jp.predict_files(paths, FRAMES, workers=2, video_batch=2))
    assert got[paths[1]] is None
    for p in paths:
        _same(got[p], want[p], p, CROP_TOL)
    _same(pp.predict_video(paths[0], FRAMES), want[paths[0]], paths[0], CROP_TOL)


@pytest.mark.parametrize("mode", ["micro", "none"])
def test_fullframe_server_takes_the_native_branch(native_lib, pair, corpus, mode,  # noqa: F811
                                                  monkeypatch):
    """serve.py, unchanged: its extract_faces call now decodes straight to
    the model size, and each response is predict_video's verdict."""
    pp, _ = pair
    opened = []
    real = native.NativeVideoReader
    monkeypatch.setattr(native, "NativeVideoReader",
                        lambda path, out_size=None: opened.append(out_size) or real(path,
                                                                                    out_size))
    batcher = MicroBatcher(pp, FRAMES, window_ms=0.0) if mode == "micro" else None
    try:
        with serving(serve.make_handler(pp, FRAMES, batcher)) as url:
            for name in ("v0.mp4", "v2.mp4"):
                path = str(corpus["videos"] / name)
                with open(path, "rb") as f:
                    code, body = _call(url + "/predict", f.read())
                assert code == 200 and body["faces_found"] == FRAMES
                want = pp.predict_video(path, FRAMES)
                assert body["y"] == want[0] and abs(body["pred"] - want[1]) <= SAME_TOL
    finally:
        if batcher is not None:
            batcher.close()
    assert opened and all(o == (IMG, IMG) for o in opened)


# ------------------------------------------------- with an in-memory decoder

@pytest.fixture
def memory(monkeypatch):
    """Six videos at the model size (mixed colour spaces and ranges; m4 has
    no frames) in both packages' data.native, and m9.mp4 that cannot be
    opened."""
    dec = InMemoryDecoder.seeded(5, IMG, (6, 4, 9, 2, 0, 5),
                                 color=(("bt601", False), ("bt709", True), ("bt709", False),
                                        ("bt601", True)))
    dec.install(monkeypatch, native, jax_native)
    return dec


@pytest.mark.parametrize("transfer", ["rgb", "yuv420"], indirect=True)
def test_in_memory_drivers_match_jax(memory, transfer):
    pp, jp = transfer
    paths = [f"/videos/m{i}.mp4" for i in (0, 1, 9, 2, 3, 4, 5)]
    want = dict(jp.predict_files(paths, FRAMES, workers=2, video_batch=2))
    got = dict(pp.predict_files(paths, FRAMES, workers=2, video_batch=2))
    assert list(got) == paths
    assert got["/videos/m4.mp4"] == want["/videos/m4.mp4"] == DEFAULT_VERDICT
    assert got["/videos/m9.mp4"] == want["/videos/m9.mp4"] == (
        None if pp.transfer_format == "yuv420" else DEFAULT_VERDICT)
    for p in paths:
        _same(got[p], want[p], (pp.transfer_format, p))
    # one video: the per-video path through the scaled reader (RGB under either format)
    _same(pp.predict_files(paths[:1], FRAMES)[0][1], jp.predict_files(paths[:1], FRAMES)[0][1],
          paths[0])
    assert all(o == (IMG, IMG) for _, o in memory.opened)


def test_in_memory_yuv_driver_equals_forward_batched_yuv(memory, pair):
    """Each predict_files_yuv verdict is forward_batched_yuv on the
    video's own planes and transform (float32: the batch aside, the same
    arithmetic); the RGB driver's, forward_batched on its frames."""
    import torch

    from genconvit_tpu_torch.data.preprocess import yuv_affine

    pp, _ = pair
    names = ["m0.mp4", "m1.mp4", "m2.mp4", "m3.mp4", "m5.mp4"]
    got_yuv = dict(pp.predict_files_yuv(names, FRAMES, workers=3, video_batch=3))
    got_rgb = dict(pp.predict_files_native_rgb(names, FRAMES, video_batch=3))
    for n in names:
        y, u, v, m, mask = pp._extract_yuv(n, FRAMES)
        wy, wv = pp.forward_batched_yuv(*(torch.from_numpy(a[None]) for a in (y, u, v, m,
                                                                              mask)))
        assert got_yuv[n][0] == int(wy[0]) and abs(got_yuv[n][1] - float(wv[0])) <= SAME_TOL
        np.testing.assert_array_equal(m, yuv_affine(*memory.videos[n][2]))
        faces = pp.extract_faces(n, FRAMES)
        assert got_rgb[n] == pytest.approx(pp.predict_faces(faces, FRAMES), abs=SAME_TOL)
