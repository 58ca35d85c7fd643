"""device_idle.*: the device's idle share of the traced slice: 1 - (the union
of its kernel, copy and memset intervals) / (the slice's wall time), in %."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
