"""launch_host_ms.*: the host's ms to enqueue one forward (span
gcv.predictor.launch: the batcher's `Predictor._launch`, the stream's
launches), total over count."""

from perfbench.metrics import _spans


def read(r):
    return _spans.mean_ms("gcv.predictor.launch")
