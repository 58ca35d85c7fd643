"""The comparison that decides `correct`, at the test size on the CPU (the
port's plain float32 path): a sound run of every cell is correct, each
fault a cell can have, planted under the timed path, makes it false, and
so does the control (the reference from float8 operands in the program's
place). The card test at the end holds each cell's control at the cell's
size."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import run as bench_run
from perfbench.core import compare

CELLS = ("tiny_score_v8", "large_score_v8", "tiny_serve_poisson", "tiny_train_vae_b32")
CPU = torch.device("cpu")


def _run(cell, seed=2**31 + 11, seconds=0.5, device=CPU, fp8=False):
    return bench_run.run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                              fp8_control=fp8)


@pytest.fixture
def train_cell(small_cell):
    return small_cell("tiny_train_vae_b32")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name):
    out = _run(small_cell(name))
    assert compare.correct(out.checks), out.checks
    assert out.attempted > 0 and out.failed == 0
    assert all(v > 0 for v in out.end_to_end.values())


@pytest.mark.parametrize("name", ("tiny_score_v8", "tiny_serve_poisson", "tiny_train_vae_b32"))
def test_control_fails(small_cell, name):
    out = _run(small_cell(name), fp8=True)
    assert not compare.correct(out.checks), out.checks


def test_training_compares_three_numbers(train_cell):
    out = _run(train_cell)
    assert set(out.checks) == {"loss_gap", "grad_gap", "change_gap"}


def _alter_verdicts(monkeypatch):
    """A verdict altered where it is produced: y_val moved by 0.05."""
    from genconvit_tpu_torch.infer import engine

    real = engine.aggregate_logits
    monkeypatch.setattr(engine, "aggregate_logits",
                        lambda logits, mask: (lambda y, v: (y, v + 0.05))(*real(logits, mask)))


def _half_the_frames(monkeypatch):
    """Half of every video's frames left out, the mean taken over the rest."""
    from genconvit_tpu_torch.infer import engine

    real = engine.aggregate_logits

    def agg(logits, mask):
        mask = mask.clone()
        mask[:, 1::2] = 0.0
        return real(logits, mask)

    monkeypatch.setattr(engine, "aggregate_logits", agg)


@pytest.mark.parametrize("name", ("tiny_score_v8", "tiny_serve_poisson"))
@pytest.mark.parametrize("fault", (_alter_verdicts, _half_the_frames))
def test_verdict_faults_fail(small_cell, monkeypatch, name, fault):
    cell = small_cell(name)
    fault(monkeypatch)
    out = _run(cell)
    assert not compare.correct(out.checks), out.checks


def _state_unchanged(monkeypatch):
    """A step that leaves the parameters as they were."""
    from genconvit_tpu_torch.train import loop

    real = loop.make_train_step

    def make(model, *a, **k):
        step = real(model, *a, **k)

        def broken(x, y, eps=None):
            keep = {n: p.detach().clone() for n, p in model.named_parameters()}
            out = step(x, y, eps)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(keep[n])
            return out
        return broken

    monkeypatch.setattr(loop, "make_train_step", make)


def _half_the_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest (the fault
    `control.py --fault half_batch` plants on the card)."""
    from genconvit_tpu_torch.train import loop

    from perfbench import control

    monkeypatch.setattr(loop, "make_train_step", control.half_batch(loop.make_train_step))


@pytest.mark.parametrize("fault", (_state_unchanged, _half_the_batch))
def test_training_faults_fail(train_cell, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(train_cell)
    assert not compare.correct(out.checks), out.checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_card(cuda, name):
    """On the card, at the cell's own size: the program is correct and its
    control (the reference from float8 operands) is not, on three seeds."""
    from perfbench.core import registry

    cell = registry.cell(name)
    for seed in (101, 2**31 + 102, 103):
        assert compare.correct(_run(cell, seed, 1.0, cuda).checks)
        out = _run(cell, seed, 1.0, cuda, fp8=True)
        assert not compare.correct(out.checks), out.checks
