"""forward_ms.*: a training step's forward (the loss) on the host, in ms:
span gcv.train.forward's self time over its count."""

from perfbench.metrics import _spans


def read(r):
    return _spans.mean_ms("gcv.train.forward", "self_s")
