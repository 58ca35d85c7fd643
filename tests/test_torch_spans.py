"""The program's spans and counters (`genconvit_tpu_torch.utils.timing`):
nothing recorded and no `record_function` entered with the profiler off;
under the profiler the batcher's cycle, the stream's staging and launches
and the training step's phases fill the table at their expected counts;
self time, threads, the timeline's thread rule, and StageTimers' keys.
Tiny ConvNeXt at 64 px on the CPU; no JAX."""

from __future__ import annotations

import concurrent.futures as cf
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.infer.batcher import MicroBatcher
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
from genconvit_tpu_torch.train import loop, optim
from genconvit_tpu_torch.utils import timing

NAME = "convnext_spans_test"
IMG, FRAMES, BACKBONE_CLASSES = 64, 3, 10
LATENT = 256 * (IMG // 32) ** 2
REQUESTS, STREAM_BATCHES, STEPS = 5, 3, 2


@pytest.fixture(autouse=True)
def clean_table():
    timing.reset_spans()
    yield
    timing.reset_spans()


@pytest.fixture
def cfg(monkeypatch):
    from genconvit_tpu_torch.models import convnext

    monkeypatch.setitem(convnext.CONVNEXT_CFGS, NAME,
                        dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64)))
    return Config(model=ModelConfig(backbone=NAME, latent_dims=LATENT), img_size=IMG)


@pytest.fixture
def pred(cfg):
    model = loop.new_model(cfg, "genconvit", torch.device("cpu"), 0, BACKBONE_CLASSES)
    return Predictor(cfg, device="cpu", params={"ed": model.ed.state_dict(),
                                                "vae": model.vae.state_dict()},
                     kernel_plan=KernelPlan(), dtype=torch.float32,
                     deterministic_vae=True, face_backend="fullframe",
                     backbone_classes=BACKBONE_CLASSES)


def _faces(rng, k):
    return rng.integers(0, 256, (k, IMG, IMG, 3), np.uint8)


def _serve(batcher, rng):
    """REQUESTS submits from threads; every verdict back."""
    with cf.ThreadPoolExecutor(REQUESTS) as pool:
        futs = [pool.submit(batcher.submit, _faces(rng, 1 + i % FRAMES))
                for i in range(REQUESTS)]
        return [f.result(timeout=60) for f in futs]


def _stream(pred, rng):
    batches = [(rng.integers(0, 256, (2, FRAMES, IMG, IMG, 3), np.uint8),
                np.ones((2, FRAMES), np.float32)) for _ in range(STREAM_BATCHES)]
    return pred.predict_videos_stream(batches)


def _train(cfg, rng):
    model = loop.new_model(cfg, "vae", torch.device("cpu"), 1, BACKBONE_CLASSES)
    step = loop.make_train_step(model, "vae", optim.make_optimizer(model.parameters(),
                                                                   1e-4, 1e-4))
    for _ in range(STEPS):
        step(torch.from_numpy(_faces(rng, 2)), torch.tensor([0, 1]), torch.zeros(2, LATENT))


def _drive(pred, cfg, batcher):
    rng = np.random.default_rng(0)
    assert len(_serve(batcher, rng)) == REQUESTS
    assert len(_stream(pred, rng)) == STREAM_BATCHES
    _train(cfg, rng)


def test_off_records_nothing_and_enters_no_record_function(pred, cfg, monkeypatch):
    entered = []
    real = timing.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(timing, "record_function", counting)
    assert not timing.recording()
    batcher = MicroBatcher(pred, FRAMES, window_ms=5.0, max_batch=4)
    try:
        _drive(pred, cfg, batcher)
    finally:
        batcher.close()
    assert timing.spans() == {}
    assert entered == []
    assert timing.span("gcv.x") is timing.span("gcv.y")   # the one shared no-op


def test_on_fills_the_table_at_the_expected_counts(pred, cfg, monkeypatch):
    entered = []
    real = timing.record_function
    monkeypatch.setattr(timing, "record_function",
                        lambda name: entered.append(name) or real(name))
    batcher = MicroBatcher(pred, FRAMES, window_ms=5.0, max_batch=4)   # worker started off
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert timing.recording()
            launches0 = batcher.launches
            _drive(pred, cfg, batcher)
            drains = batcher.launches - launches0
            batcher.close()
    finally:
        batcher.close()
    got = timing.spans()
    count = {k: v["count"] for k, v in got.items()}
    assert drains >= 2   # 5 requests, at most 4 a drain
    for name in ("gcv.batcher.window", "gcv.batcher.drain", "gcv.batcher.fetch",
                 "gcv.batcher.deliver"):
        assert count[name] == drains, name
    assert count["gcv.batcher.submit"] == REQUESTS
    assert count["gcv.batcher.queue_wait"] == REQUESTS
    assert count["gcv.batcher.idle"] >= 1
    assert count["gcv.predictor.launch"] == drains + STREAM_BATCHES
    assert count["gcv.predictor.stage"] == STREAM_BATCHES
    assert count["gcv.stage.device_forward"] == 1   # the stream's one fetch
    for name in ("gcv.train.forward", "gcv.train.backward", "gcv.train.optimizer",
                 "gcv.train.bn_write_back"):
        assert count[name] == STEPS, name
    assert "gcv.train.grad_sync" not in count   # no group
    assert all(name.startswith("gcv.") for name in count)
    for row in got.values():
        assert 0.0 <= row["self_s"] <= row["total_s"] + 1e-12
    # one record_function per span entered; a counter opens none
    assert len(entered) == sum(n for k, n in count.items() if k != "gcv.batcher.queue_wait")
    assert got["gcv.batcher.queue_wait"]["total_s"] > 0.0


def test_queue_wait_counts_requests_enqueued_while_on(pred):
    """A request enqueued before the profiler started is not counted,
    though it is drained while the profiler records."""
    gate, at_gate = threading.Event(), threading.Event()
    real_launch = pred._launch

    def gated(*a, **k):
        at_gate.set()
        gate.wait(30)
        return real_launch(*a, **k)

    pred._launch = gated
    batcher = MicroBatcher(pred, FRAMES, window_ms=0.0, max_batch=1)
    rng = np.random.default_rng(1)
    with cf.ThreadPoolExecutor(3) as pool:
        try:
            first = [pool.submit(batcher.submit, _faces(rng, 1)) for _ in range(2)]
            assert at_gate.wait(30)   # one launch held at the gate
            deadline = time.monotonic() + 30
            while len(batcher._queue) < 1 and time.monotonic() < deadline:
                time.sleep(0.005)   # and one request queued, stamped while off
            with profile(activities=[ProfilerActivity.CPU]):
                late = pool.submit(batcher.submit, _faces(rng, 1))
                while len(batcher._queue) < 2 and time.monotonic() < deadline:
                    time.sleep(0.005)
                gate.set()
                for f in first + [late]:
                    f.result(timeout=60)
        finally:
            gate.set()
            batcher.close()
    count = timing.spans()["gcv.batcher.queue_wait"]["count"]
    assert count == 1


def test_self_time_of_a_nested_pair():
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("gcv.test.outer"):
            time.sleep(0.01)
            with timing.span("gcv.test.inner"):
                time.sleep(0.02)
            timing.add("gcv.test.counter", 0.5)   # a counter is not nested time
    got = timing.spans()
    outer, inner = got["gcv.test.outer"], got["gcv.test.inner"]
    assert inner["self_s"] == inner["total_s"] >= 0.02
    assert outer["total_s"] >= inner["total_s"] + 0.01
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert got["gcv.test.counter"] == {"count": 1, "total_s": 0.5, "self_s": 0.5}


def test_a_span_the_profiler_cuts_is_left_out():
    """Counted only where the profiler records at entry and exit: the
    table covers the profiled stretch alone."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    try:
        with timing.span("gcv.test.outlives"):
            with timing.span("gcv.test.inside"):
                pass
            prof.__exit__(None, None, None)
    finally:
        if timing.recording():
            prof.__exit__(None, None, None)
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("gcv.test.counted"):
            pass
    with timing.span("gcv.test.precedes"):
        with profile(activities=[ProfilerActivity.CPU]):
            pass
    assert set(timing.spans()) == {"gcv.test.inside", "gcv.test.counted"}


def test_threads_count_every_span():
    threads_n, per = 4, 50
    start = threading.Barrier(threads_n)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def work():
                start.wait(10)
                for _ in range(per):
                    with timing.span("gcv.test.thread"):
                        with timing.span("gcv.test.thread_inner"):
                            pass

            threads = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = timing.spans()
    assert got["gcv.test.thread"]["count"] == threads_n * per
    assert got["gcv.test.thread_inner"]["count"] == threads_n * per
    outer, inner = got["gcv.test.thread"], got["gcv.test.thread_inner"]
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-6)


@pytest.mark.parametrize("all_threads", [False, True])
def test_worker_ranges_reach_the_timeline_only_under_profile_all_threads(pred, all_threads):
    """The batcher's worker started before the profiler: its ranges are in
    the profiler's events only with profile_all_threads; the table counts
    them either way."""
    from torch._C._profiler import _ExperimentalConfig

    batcher = MicroBatcher(pred, FRAMES, window_ms=1.0, max_batch=4)
    kw = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)} \
        if all_threads else {}
    try:
        with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
            _serve(batcher, np.random.default_rng(2))
    finally:
        batcher.close()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    worker = {"gcv.batcher.window", "gcv.batcher.drain", "gcv.batcher.fetch",
              "gcv.batcher.deliver", "gcv.predictor.launch"}
    assert (worker <= names) is all_threads
    assert not (worker & names) or all_threads
    assert worker <= set(timing.spans())


def test_stage_timers_keep_their_keys_and_open_a_span():
    t = timing.StageTimers()
    with profile(activities=[ProfilerActivity.CPU]):
        with t.stage("decode"):
            pass
    with t.stage("device_forward"):
        pass
    summary = t.summary()
    assert list(summary) == ["decode", "device_forward"]
    assert all(set(v) == {"total_seconds", "count", "mean_ms"} for v in summary.values())
    assert set(timing.spans()) == {"gcv.stage.decode"}
    off = timing.StageTimers(enabled=False)
    with off.stage("crop"):
        pass
    assert off.summary() == {}
