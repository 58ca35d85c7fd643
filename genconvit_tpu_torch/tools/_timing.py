"""What the probe tools share: the device, a timer and the bound."""

from __future__ import annotations

import time
from typing import Callable

import torch

# NVIDIA H100 SXM published peaks (dense): bytes/s, bf16 and int8 tensor-core
# operations/s, float32 operations/s outside the tensor cores
HBM, BF16, INT8, FP32 = 3.35e12, 989e12, 1979e12, 67e12


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: CUDA is not available (pass --device cpu for the plain "
                         f"versions on the host)")
    return dev


def clock_label(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"CUDA events, {torch.cuda.get_device_name(dev)}"
    return "host clock on the CPU: the plain version, not a device time"


def time_ms(fn: Callable[[], object], dev: torch.device, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of fn over iters calls after warmup ones: CUDA
    events around the run on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, *units: dict) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    the bytes over the memory rate or the busiest unit's operations
    ({peak: count}) over its peaks, whichever is larger."""
    t_bytes = nbytes / HBM
    t_ops = max(sum(n / peak for peak, n in ops.items()) for ops in units)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
