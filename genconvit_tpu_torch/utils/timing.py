"""Per-stage timing (copy of genconvit_tpu/utils/timing.py:15-55): thread-
safe accumulators of host wall time per named stage (decode, detect, crop,
device_forward in the Predictor's drivers). A stage that only enqueues
device work measures the enqueue; the drivers' final fetch carries the
device's remaining time under 'device_forward'."""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict


class StageTimers:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._total: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
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
