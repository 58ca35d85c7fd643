"""A traced slice: torch.profiler over a few seconds of steady work, reduced
to what the per-layer readers and the result's `breakdown` need.

Busy time is the union of the device's kernel, copy and memset intervals
(overlapping streams count once); the profiler's GPU-side user
annotations, which mirror host ranges, are not device work. Idle gaps are
the holes in that union, each named by the innermost host range (an op
or one of the harness's `bench.*` annotations) that spans its middle.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, NamedTuple, Tuple

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "bench.slice"
SHORT_GAP = 20e-6     # gaps shorter than this are summed, not named
SHORT_NAME = "(launch gaps under 20 us)"


class Kernel(NamedTuple):
    name: str
    start: float   # s, from the slice's start
    dur: float     # s


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    kernels: List[Kernel]
    gaps: List[Tuple[str, float]]   # (host range spanning the gap, seconds), by gap
    kinds: Dict[str, List[float]]   # every device-side event by activity type: [count, seconds]


def _activity(e) -> str:
    """The event's kineto activity type ('kernel', 'gpu_memcpy', ...), or ''
    where this torch does not give it."""
    try:
        return str(e.activity_type()).lower()
    except (AttributeError, RuntimeError, TypeError):
        return ""


def _annotation(e) -> bool:
    try:
        return bool(e.is_user_annotation())
    except (AttributeError, RuntimeError, TypeError):
        return False


def _device_work(e, act: str, host_marks) -> bool:
    """A kernel, copy or memset: by its activity type where torch gives one,
    else by leaving out user annotations and synchronizations."""
    if act:
        return any(k in act for k in DEVICE_WORK) and "annotation" not in act
    name = e.name()
    return not (_annotation(e) or name in host_marks or "sync" in name.lower())


def _is_device(e) -> bool:
    return "cuda" in str(e.device_type()).lower()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events, t0_ns: int, t1_ns: int) -> TraceSummary:
    """Reduce kineto events (start_ns/duration_ns/name/device_type) between
    t0_ns and t1_ns (the slice, on the profiler's clock)."""
    window = (t1_ns - t0_ns) * 1e-9
    host_marks = {e.name() for e in events if not _is_device(e) and _annotation(e)}
    kernels: List[Kernel] = []
    host: List[Tuple[float, float, str]] = []
    kinds: Dict[str, List[float]] = {}
    for e in events:
        a = (e.start_ns() - t0_ns) * 1e-9
        d = e.duration_ns() * 1e-9
        if _is_device(e):
            act = _activity(e)
            kind = kinds.setdefault(act or "(no activity type)", [0, 0.0])
            kind[0] += 1
            kind[1] += d
            lo, hi = max(a, 0.0), min(a + d, window)
            if hi > lo and _device_work(e, act, host_marks):
                kernels.append(Kernel(e.name(), lo, hi - lo))
        elif d > 0:
            host.append((a, a + d, e.name()))
    spans = _union([(k.start, k.start + k.dur) for k in kernels])
    busy = sum(b - a for a, b in spans if b > a)
    holes = []
    prev = 0.0
    for a, b in spans + [(window, window)]:
        if a > prev:
            holes.append((prev, a))
        prev = max(prev, b)
    host.sort(key=lambda h: h[0])
    starts = [h[0] for h in host]
    gaps = []
    for a, b in holes:
        if b - a < SHORT_GAP:
            gaps.append((SHORT_NAME, b - a))
            continue
        mid = 0.5 * (a + b)
        name = "(no host range)"
        # the latest-starting host range that spans the middle: the innermost
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        gaps.append((name, b - a))
    return TraceSummary(window, busy, kernels, gaps, kinds)


def traced(torch, work: Callable[[], None]) -> TraceSummary:
    """Profile `work` and summarize it. The slice is the `bench.slice` range
    around work and a device synchronize, on the profiler's own clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            work()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    mark = next(e for e in events if e.name() == SLICE and not _is_device(e))
    return summarize(events, mark.start_ns(), mark.start_ns() + mark.duration_ns())


def describe(s: TraceSummary) -> str:
    """A line for the log: the slice, and the device-side events by kind."""
    kinds = ", ".join(f"{k} {n:.0f} ({t:.4f} s)" for k, (n, t) in sorted(s.kinds.items()))
    return (f"traced slice {s.window_s:.4f} s, device busy {s.busy_s:.4f} s over "
            f"{len(s.kernels)} kernels/copies; device events by kind: {kinds}")


def by_group(kernels: List[Kernel], group: Callable[[str], str], top: int = 10
             ) -> List[List]:
    """[[group, seconds], ...] of the device time, largest first."""
    acc: Dict[str, float] = {}
    for k in kernels:
        g = group(k.name)
        acc[g] = acc.get(g, 0.0) + k.dur
    return [[g, t] for g, t in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def gaps_by_host(gaps: List[Tuple[str, float]], top: int = 10) -> List[List]:
    """[[host range, seconds], ...]: idle time summed by what the host was
    doing, largest first."""
    acc: Dict[str, float] = {}
    for name, t in gaps:
        acc[name] = acc.get(name, 0.0) + t
    return [[n, t] for n, t in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def count(kernels: List[Kernel], match: Callable[[str], bool]) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name matches."""
    hits = [k.dur for k in kernels if match(k.name)]
    return len(hits), sum(hits)
