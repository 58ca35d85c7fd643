"""latency_p95_ms.*: the 95th percentile (nearest rank) over every request
due in the untraced window, from the same clock as latency_p50_ms."""


def read(r):
    return r.window.get("latency_p95_ms")
