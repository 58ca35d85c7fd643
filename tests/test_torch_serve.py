"""The port's serving path against the repository's on the CPU: the port's
`serve.make_handler` in its three modes (StagedPipeline, MicroBatcher, the
lock) against the root `serve.make_handler` over the JAX Predictor, both
loading the same `.gcv` weights (the small backbone of test_torch_util,
64 px, float32, the heads' last layer scaled so that verdicts are
decisive), net='ed' and 'genconvit' with deterministic_vae=True on both
sides, through real HTTP on 127.0.0.1 with the same mp4 bodies. y_val
within 2e-3 (the face crops may differ from cv2's by 1 LSB, the drivers'
bound), equal labels where |y_val - 0.5| > 1e-2. Coalesced verdicts against
the port's own single-request ones within 1e-5 (the same float32
arithmetic, the batch aside). Every HTTP call has a timeout; servers,
batchers and pipelines are closed in fixtures or `finally`."""

import concurrent.futures as cf
import contextlib
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from genconvit_tpu.config import Config as JaxConfig
from genconvit_tpu.infer import engine as jax_engine

from genconvit_tpu_torch import serve
from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.infer import engine
from genconvit_tpu_torch.infer.aggregate import DEFAULT_VERDICT
from genconvit_tpu_torch.infer.batcher import MicroBatcher
from genconvit_tpu_torch.infer.serve_pipeline import StagedPipeline
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_drivers import _write_video
from tests.test_torch_util import IMG, small_backbone_registered, write_gcv_weights

FRAMES = 4
YVAL_TOL = 2e-3
LABEL_MARGIN = 1e-2
SAME_TOL = 1e-5
HTTP_TIMEOUT = 60
N_VIDEOS = 4
MODES = ("staged", "micro", "none")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    write_gcv_weights(root / "weights")
    bodies = []
    for i in range(N_VIDEOS):
        path = str(root / f"v{i}.mp4")
        _write_video(path, seed=20 + i)
        with open(path, "rb") as f:
            bodies.append(f.read())
    sidecar = root / "no_boxes.json"
    sidecar.write_text("{}")
    with small_backbone_registered() as backbone:
        yield {"root": root, "weights": str(root / "weights"), "bodies": bodies,
               "sidecar": str(sidecar), "backbone": backbone}


def _port(corpus, net, backend="center"):
    cfg = Config(model=ModelConfig(backbone=corpus["backbone"]), img_size=IMG,
                 weight_dir=corpus["weights"])
    return engine.Predictor(cfg, net=net, device="cpu", face_backend=backend,
                            deterministic_vae=True, kernel_plan=KernelPlan())


def _jax(corpus, net, backend="center"):
    cfg = JaxConfig()
    cfg.img_size = IMG
    cfg.model.latent_dims = cfg.derived_latent_dims()
    cfg.weight_dir = corpus["weights"]
    return jax_engine.Predictor(cfg, net=net, face_backend=backend, deterministic_vae=True)


@contextlib.contextmanager
def serving(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


@contextlib.contextmanager
def port_server(pred, mode, window_ms=100.0):
    """The port's server in `mode`; the stage it batches through is closed after."""
    batcher = MicroBatcher(pred, FRAMES, window_ms=window_ms) if mode == "micro" else None
    pipeline = (StagedPipeline(pred, FRAMES, decode_workers=4, window_ms=window_ms)
                if mode == "staged" else None)
    try:
        with serving(serve.make_handler(pred, FRAMES, batcher, pipeline)) as url:
            yield url, batcher or pipeline
    finally:
        for stage in (batcher, pipeline):
            if stage is not None:
                stage.close()


def _call(url, data=None, method=None):
    req = urllib.request.Request(url, data=data, method=method or ("POST" if data is not None
                                                                   else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.load(e)


def _post_all(url, bodies, workers):
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda b: _call(url + "/predict", b), bodies))


@pytest.fixture(scope="module")
def predictors(corpus):
    """Per net: (port Predictor, the root server's responses to the bodies
    and to /statz, the JAX Predictor)."""
    from serve import make_handler as root_handler

    out = {}
    for net in ("ed", "genconvit"):
        jp = _jax(corpus, net)
        with serving(root_handler(jp, FRAMES)) as url:
            want = [_call(url + "/predict", b) for b in corpus["bodies"]]
            want_statz = _call(url + "/statz")
        out[net] = (_port(corpus, net), want, want_statz, jp)
    return out


@pytest.mark.parametrize("net", ["ed", "genconvit"])
@pytest.mark.parametrize("mode", MODES)
def test_server_matches_root_server(predictors, corpus, net, mode):
    pred, want, want_statz, _ = predictors[net]
    with port_server(pred, mode, window_ms=0.0) as (url, stage):
        got = [_call(url + "/predict", b) for b in corpus["bodies"]]
        code, statz = _call(url + "/statz")
    decisive = 0
    for (gc, g), (wc, w) in zip(got, want):
        assert gc == wc == 200
        assert set(g) == set(w) == {"pred_label", "pred", "y", "num_frames", "faces_found"}
        assert g["num_frames"] == w["num_frames"] == FRAMES
        assert g["faces_found"] == w["faces_found"] == FRAMES
        assert abs(g["pred"] - w["pred"]) <= YVAL_TOL, (g, w)
        if abs(w["pred"] - 0.5) > LABEL_MARGIN:
            decisive += 1
            assert (g["y"], g["pred_label"]) == (w["y"], w["pred_label"]), (g, w)
    assert decisive >= 2   # the label check is not vacuous
    assert code == 200
    if mode == "none":
        assert statz == want_statz[1] == {"mode": "lock-serialized"}
    else:
        assert statz == {"mode": "staged" if mode == "staged" else "micro-batched",
                         "device_launches": N_VIDEOS, "videos_scored": N_VIDEOS}


@pytest.mark.parametrize("mode", MODES)
def test_server_errors_match_root_server(predictors, corpus, mode):
    """Garbage body: 500 with the decode error; no body: 400; unknown
    path: 404 on GET and POST; /healthz: 200. The root server answers the
    same codes."""
    from serve import make_handler as root_handler

    pred, jp = predictors["ed"][0], predictors["ed"][3]
    calls = [("/predict", b"not a video at all" * 8), ("/predict", b""), ("/nope", None),
             ("/nope", b"x"), ("/healthz", None)]
    with port_server(pred, mode) as (url, _):
        got = [_call(url + path, data) for path, data in calls]
    with serving(root_handler(jp, FRAMES)) as url:
        root = [_call(url + path, data) for path, data in calls]
    assert [c for c, _ in got] == [c for c, _ in root] == [500, 400, 404, 404, 200]
    assert "cannot open video" in got[0][1]["error"]
    assert got[1][1] == {"error": "missing or oversized body"}
    assert got[2][1] == got[3][1] == {"error": "unknown path"}
    assert got[4][1] == {"status": "ok"}


@pytest.mark.parametrize("mode", ["staged", "micro"])
def test_concurrent_requests_coalesce(predictors, corpus, mode):
    """8 concurrent POSTs land in fewer launches than requests, and each
    verdict is the one the request gets alone."""
    pred = predictors["genconvit"][0]
    bodies = [corpus["bodies"][i % N_VIDEOS] for i in range(8)]
    with port_server(pred, mode) as (url, stage):
        alone = [_call(url + "/predict", b)[1] for b in corpus["bodies"]]
        before = stage.launches
        got = _post_all(url, bodies, 8)
        launches = stage.launches - before
        statz = _call(url + "/statz")[1]
    assert launches < 8, "requests were not batched"
    assert statz["videos_scored"] == 8 + N_VIDEOS
    for i, (code, g) in enumerate(got):
        assert code == 200
        assert abs(g["pred"] - alone[i % N_VIDEOS]["pred"]) <= SAME_TOL
        assert g["y"] == alone[i % N_VIDEOS]["y"]


@pytest.mark.parametrize("mode", MODES)
def test_zero_faces_short_circuit(corpus, mode):
    """Recorded boxes with none for any video: every request gets the
    (0, 0.5) default with faces_found 0 and no launch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GENCONVIT_FACE_SIDECAR", corpus["sidecar"])
        pred = _port(corpus, "ed", backend="recorded")
    with port_server(pred, mode) as (url, stage):
        got = _post_all(url, corpus["bodies"][:2], 2)
        statz = _call(url + "/statz")[1]
    for code, g in got:
        assert code == 200
        assert (g["y"], g["pred"], g["faces_found"]) == (0, 0.5, 0)
    if stage is not None:
        assert statz["device_launches"] == statz["videos_scored"] == 0
    mb = MicroBatcher(pred, FRAMES, window_ms=1.0)
    try:
        assert mb.submit(np.zeros((0, IMG, IMG, 3), np.uint8)) == DEFAULT_VERDICT
        assert mb.launches == 0
    finally:
        mb.close()


def _frames_source(mp, n):
    """engine.extract_frames substituted by seeded in-memory frames:
    'a{i}' videos, 'empty' (no frame) and anything else raises."""
    rng = np.random.default_rng(4)
    frames = {f"a{i}": rng.integers(0, 256, (FRAMES, 72, 96, 3), np.uint8) for i in range(n)}
    frames["empty"] = np.zeros((0, 0, 0, 3), np.uint8)

    def fake(path, num_frames, prefer_native=True):
        if path not in frames:
            raise IOError(f"no such video {path}")
        return frames[path]

    mp.setattr(engine, "extract_frames", fake)


def test_staged_pipeline_decodes_through_engine_and_isolates_errors(predictors):
    """Decode goes through engine.extract_frames looked up when called: a
    substituted source serves the pipeline; zero frames give the default,
    a failed decode fails that request alone, and the verdicts equal
    predict_video's on the same source."""
    pred = predictors["genconvit"][0]
    with pytest.MonkeyPatch.context() as mp:
        _frames_source(mp, 3)
        pipe = StagedPipeline(pred, FRAMES, decode_workers=2, window_ms=200.0)
        try:
            with cf.ThreadPoolExecutor(max_workers=5) as ex:
                futs = {p: ex.submit(pipe.submit, p, 60) for p in ("a0", "a1", "empty", "bad", "a2")}
                with pytest.raises(IOError, match="no such video"):
                    futs["bad"].result()
                got = {p: f.result() for p, f in futs.items() if p != "bad"}
        finally:
            pipe.close()
        assert got["empty"] == (0, 0.5, 0)
        for p in ("a0", "a1", "a2"):
            y, y_val = pred.predict_video(p, FRAMES)
            assert got[p][0] == y and abs(got[p][1] - y_val) <= SAME_TOL and got[p][2] == FRAMES
    assert pipe.batched_videos == 3 and pipe.launches < 3


@pytest.mark.parametrize("stage_kind", ["staged", "micro"])
def test_failed_launch_reaches_every_waiter_and_the_worker_survives(predictors, stage_kind):
    pred = predictors["ed"][0]
    faces = [np.random.default_rng(i).integers(0, 256, (FRAMES, IMG, IMG, 3), np.uint8)
             for i in range(4)]
    with pytest.MonkeyPatch.context() as mp:
        _frames_source(mp, 4)
        if stage_kind == "staged":
            stage = StagedPipeline(pred, FRAMES, decode_workers=4, window_ms=100.0)
            args = [f"a{i}" for i in range(4)]
        else:
            stage = MicroBatcher(pred, FRAMES, window_ms=100.0)
            args = faces
        try:
            def boom(*a, **k):
                raise RuntimeError("planted launch failure")

            pred.forward_batched = boom   # an instance attribute over the method
            try:
                with cf.ThreadPoolExecutor(max_workers=4) as ex:
                    futs = [ex.submit(stage.submit, a, 60) for a in args]
                    errors = [f.exception(timeout=HTTP_TIMEOUT) for f in futs]
            finally:
                del pred.forward_batched
            assert all(isinstance(e, RuntimeError) and "planted" in str(e) for e in errors)
            assert stage.launches == 0
            ok = stage.submit(args[0], 60)
            assert ok[0] in (0, 1) and stage.launches == 1
        finally:
            stage.close()


def _wait_for(cond, what, seconds=30.0):
    deadline = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


@pytest.mark.parametrize("stage_kind", ["staged", "micro"])
def test_close_drains_accepted_requests_then_refuses(predictors, stage_kind):
    """Six requests held inside the stage (their decodes, or the first
    drain's launch, wait on a gate) when close() starts: close() refuses
    new ones at once, and returns once the six are answered."""
    pred = predictors["ed"][0]
    gate, held = threading.Event(), []
    with pytest.MonkeyPatch.context() as mp:
        _frames_source(mp, 6)
        if stage_kind == "staged":
            source = engine.extract_frames

            def gated_decode(path, num_frames, prefer_native=True):
                held.append(1)
                gate.wait(HTTP_TIMEOUT)
                return source(path, num_frames, prefer_native)

            mp.setattr(engine, "extract_frames", gated_decode)
            stage = StagedPipeline(pred, FRAMES, decode_workers=6)
            args = [f"a{i}" for i in range(6)]
            accepted = lambda: len(held) == 6   # every decode has started
        else:
            forward = pred.forward_batched

            def gated_forward(frames, mask):
                held.append(len(frames))
                gate.wait(HTTP_TIMEOUT)
                return forward(frames, mask)

            pred.forward_batched = gated_forward   # an instance attribute over the method
            stage = MicroBatcher(pred, FRAMES, window_ms=0.0, max_batch=2)
            args = [np.full((FRAMES, IMG, IMG, 3), 40 * i, np.uint8) for i in range(6)]
            accepted = lambda: len(stage._queue) + sum(held) == 6
        try:
            with cf.ThreadPoolExecutor(max_workers=6) as ex:
                futs = [ex.submit(stage.submit, a, HTTP_TIMEOUT) for a in args]
                _wait_for(accepted, "the six requests were not all accepted")
                closer = threading.Thread(target=stage.close)
                closer.start()
                _wait_for(lambda: stage._closed, "close() did not start")
                with pytest.raises(RuntimeError, match="closed"):
                    stage.submit(args[0], 5)
                gate.set()
                results = [f.result(timeout=HTTP_TIMEOUT) for f in futs]
                closer.join(HTTP_TIMEOUT)
                assert not closer.is_alive()
        finally:
            gate.set()
            pred.__dict__.pop("forward_batched", None)
    assert all(r[0] in (0, 1) for r in results)
    assert stage.batched_videos == 6


def test_build_warms_each_mode_and_needs_the_gpu(corpus, tmp_path, monkeypatch):
    """serve.build: the flags' predictor and stage, warm (one forward at
    --max-batch); micro with a 0 ms window is the lock mode, as in the root
    server; without --device it runs on the card, so here it raises."""
    from tests.test_torch_util import write_small_config

    monkeypatch.setenv("GENCONVIT_CONFIG", write_small_config(tmp_path / "config.yaml"))
    common = ["--weights-dir", corpus["weights"], "--f", str(FRAMES), "--net", "ed",
              "--face-backend", "center", "--max-batch", "2"]
    seen = []
    forward = engine.Predictor.forward_batched
    monkeypatch.setattr(engine.Predictor, "forward_batched",
                        lambda self, f, m: seen.append(tuple(f.shape)) or forward(self, f, m))
    for flags, mode, kind in ((["--batcher", "staged"], "staged", StagedPipeline),
                              (["--batcher", "micro"], "micro", MicroBatcher),
                              (["--batcher", "micro", "--batch-window-ms", "0"], "none", None),
                              (["--batcher", "none"], "none", None)):
        seen.clear()
        pred, batcher, pipeline, got_mode = serve.build(
            serve.gen_parser().parse_args(common + flags + ["--device", "cpu"]))
        try:
            assert got_mode == mode and pred.device.type == "cpu"
            assert (type(pipeline or batcher) if kind else None) is kind
            assert seen == [(2 if kind else 1, FRAMES, IMG, IMG, 3)]
        finally:
            for stage in (batcher, pipeline):
                if stage is not None:
                    stage.close()
    monkeypatch.setattr(engine.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build(serve.gen_parser().parse_args(common))
