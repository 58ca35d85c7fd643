"""Per-stage timing and the program's spans and counters.

`StageTimers` (copy of genconvit_tpu/utils/timing.py:15-55): thread-safe
accumulators of host wall time per named stage (decode, detect, crop,
device_forward in the Predictor's drivers). A stage that only enqueues
device work measures the enqueue; 'device_forward' is the host's wait at
a call's final fetch of its verdicts, which carries whatever device work
is still queued then: it is not the device's time.

Spans and counters: `span(name)` marks a region of the program,
`add(name, seconds)` counts a duration measured elsewhere (a request's
wait in a queue) and `count(name, n)` adds n occurrences of no duration
(the windows an attention call attends). All three record only while
`torch.profiler` records (a span that the profiler's start or stop cuts
is left out), in one process-wide table that `spans()` reads: per name
its count, total seconds and self seconds (the total less the spans
nested in it on the same thread). A span also opens `record_function(name)`, so that an operator who runs
the scoring or serving CLI under `torch.profiler` sees the range on the
profiler's timeline beside the device's kernels. Off, a span costs one
read of the profiler's process-wide flag; it takes no clock, no lock and
no `record_function`.

The program's names, each entered once per unit of work:

  gcv.stage.<stage>       every StageTimers stage (gcv.stage.device_forward:
                          the fetch's wait)
  gcv.predictor.launch    a forward's host enqueue (Predictor._launch, the
                          stream's launches)
  gcv.predictor.stage     the stream's staging of one batch: as_tensor,
                          pin_memory, the copy stream's enqueue
  gcv.batcher.idle        MicroBatcher's worker waiting on an empty queue
  gcv.batcher.window      its window sleep
  gcv.batcher.drain       its take of up to max_batch requests
  gcv.batcher.fetch       its fetch of a launch's verdicts
  gcv.batcher.deliver     its hand-back of those verdicts to the requests
  gcv.batcher.submit      a request's padding and upload, to its enqueue
  gcv.batcher.queue_wait  (counter) a request's wait from enqueue to drain
  gcv.train.forward       a training step's loss (the forward)
  gcv.train.backward      its backward
  gcv.train.grad_sync     its gradients' all-reduce (data parallelism)
  gcv.train.optimizer     its optimizer step
  gcv.train.bn_write_back its BatchNorm statistics' write-back
  gcv.swin.attention      a Swin block's attention half: LN1, the rolls, the
                          window partition and reverse, qkv, the attention,
                          proj and the residual (models/swin.py)
  gcv.swin.mlp            a Swin block's MLP half (K1, or the plain half)
  gcv.swin.merge          a Swin patch merging
  gcv.swin.windows        (counter) the windows an attention call attends
  gcv.swin.masked_windows (counter) those of them under the shifted-window mask

A range opened on a thread that was running before the profiler started
(the batcher's worker, a server's request threads) reaches the profiler's
timeline only under `experimental_config=_ExperimentalConfig(
profile_all_threads=True)`; the table counts it either way.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

import torch.autograd.profiler as _profiler
from torch.profiler import record_function


class StageTimers:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._total: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Times the block under `name`, and opens the span
        gcv.stage.<name> around it."""
        with span("gcv.stage." + name):
            if not self.enabled:
                yield
                return
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self._total[name] = self._total.get(name, 0.0) + dt
                    self._count[name] = self._count.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_seconds": round(self._total[name], 4),
                    "count": self._count[name],
                    "mean_ms": round(1000 * self._total[name] / self._count[name], 2),
                }
                for name in sorted(self._total)
            }

    def reset(self) -> None:
        with self._lock:
            self._total.clear()
            self._count.clear()


_lock = threading.Lock()
_table: Dict[str, List[float]] = {}     # name -> [count, total_s, self_s]
_local = threading.local()             # .stack: this thread's open spans


def recording() -> bool:
    """Whether spans and counters record now: the profiler's process-wide
    flag, which every thread sees (the C check is per thread)."""
    return _profiler._is_profiler_enabled


def _record(name: str, total: float, own: float) -> None:
    with _lock:
        row = _table.get(name)
        if row is None:
            _table[name] = [1, total, own]
        else:
            row[0] += 1
            row[1] += total
            row[2] += own


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "_range", "_t0", "_inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self._inner = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1]._inner += dt
        self._range.__exit__(*exc)
        if _profiler._is_profiler_enabled:
            _record(self.name, dt, dt - self._inner)
        return False


def span(name: str):
    """A context manager timing its block under `name` where the profiler
    records at its entry and at its exit; otherwise it does nothing."""
    return _Span(name) if _profiler._is_profiler_enabled else _OFF


def add(name: str, seconds: float) -> None:
    """Counts one occurrence of `name` lasting `seconds` (total and self)
    while the profiler records."""
    if _profiler._is_profiler_enabled:
        _record(name, seconds, seconds)


def count(name: str, n: int) -> None:
    """Counts n occurrences of `name`, of no duration, while the profiler
    records."""
    if _profiler._is_profiler_enabled:
        with _lock:
            row = _table.setdefault(name, [0, 0.0, 0.0])
            row[0] += n


def spans() -> Dict[str, Dict[str, float]]:
    """A snapshot of the table: {name: {"count", "total_s", "self_s"}}."""
    with _lock:
        return {name: {"count": int(n), "total_s": t, "self_s": s}
                for name, (n, t, s) in _table.items()}


def reset_spans() -> None:
    with _lock:
        _table.clear()
