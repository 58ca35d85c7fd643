"""backward_ms.*: a training step's backward on the host, in ms: span
gcv.train.backward's self time over its count."""

from perfbench.metrics import _spans


def read(r):
    return _spans.mean_ms("gcv.train.backward", "self_s")
