"""optimizer_ms.*: a training step's optimizer step on the host, in ms:
span gcv.train.optimizer's self time over its count."""

from perfbench.metrics import _spans


def read(r):
    return _spans.mean_ms("gcv.train.optimizer", "self_s")
