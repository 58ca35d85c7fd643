"""The readers of the program's spans (`metrics/_spans.py` and the metrics
that use it): the right value from a table filled by hand, nothing from an
empty table or from a program without the table."""

from __future__ import annotations

import pytest

from perfbench.core import registry


def _row(count, total, own=None):
    return {"count": count, "total_s": total, "self_s": total if own is None else own}


TABLE = {
    "gcv.batcher.window": _row(10, 0.080),
    "gcv.batcher.drain": _row(10, 0.002),
    "gcv.batcher.deliver": _row(10, 0.003),
    "gcv.batcher.fetch": _row(10, 0.300),
    "gcv.batcher.idle": _row(2, 0.500),
    "gcv.batcher.queue_wait": _row(80, 40.0),
    "gcv.predictor.launch": _row(10, 0.150),
    "gcv.predictor.stage": _row(8, 0.024),
    "gcv.train.forward": _row(4, 0.400, 0.360),
    "gcv.train.backward": _row(4, 0.800, 0.800),
    "gcv.train.optimizer": _row(4, 0.120, 0.100),
}

WANT = {   # ms
    "batcher_gap_ms.serve": 8.5,            # (80 + 2 + 3) / 10
    "launch_host_ms.serve": 15.0,
    "launch_host_ms.score": 15.0,
    "queue_wait_ms.serve": 500.0,
    "stage_host_ms.score": 3.0,
    "forward_ms.train": 90.0,               # self time
    "backward_ms.train": 200.0,
    "optimizer_ms.train": 25.0,
}


def _spans_metrics():
    names = {m["name"] for m in registry.benchmark()["per_layer"]
             if m["source"] == "program_counter" and m["unit"] == "ms"}
    assert names == set(WANT)
    return sorted(names)


@pytest.fixture
def timing():
    from genconvit_tpu_torch.utils import timing

    return timing


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_table(name, timing, monkeypatch):
    monkeypatch.setattr(timing, "spans", lambda: {k: dict(v) for k, v in TABLE.items()})
    assert registry.reader(name).read(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_from_an_empty_table(name, timing, monkeypatch):
    monkeypatch.setattr(timing, "spans", dict)
    assert registry.reader(name).read(None) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_without_the_table(name, timing, monkeypatch):
    """The parent commit's program: utils.timing holds StageTimers alone."""
    monkeypatch.delattr(timing, "spans")
    assert registry.reader(name).read(None) is None


def test_batcher_gap_needs_the_fetch_count(timing, monkeypatch):
    table = {k: v for k, v in TABLE.items() if k != "gcv.batcher.fetch"}
    monkeypatch.setattr(timing, "spans", lambda: table)
    assert registry.reader("batcher_gap_ms.serve").read(None) is None


def test_every_span_metric_is_declared_with_one_cell():
    bench = registry.benchmark()
    for name in _spans_metrics():
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert len(m["workloads"]) == 1 and m["better"] == "lower"
