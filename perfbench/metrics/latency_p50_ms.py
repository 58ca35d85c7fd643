"""latency_p50_ms.*: the median (nearest rank) over every request due in the
untraced window, each timed from its due time to its verdict in the client."""


def read(r):
    return r.window.get("latency_p50_ms")
