"""stage_host_ms.*: the host's ms to stage one batch of the scoring stream
(span gcv.predictor.stage: as_tensor, pin_memory and the copy stream's
enqueue), total over count."""

from perfbench.metrics import _spans


def read(r):
    return _spans.mean_ms("gcv.predictor.stage")
