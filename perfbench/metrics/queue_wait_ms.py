"""queue_wait_ms.*: a request's mean wait in the batcher's queue, from its
enqueue to the drain that takes it (counter gcv.batcher.queue_wait, one a
request enqueued while the profiler recorded)."""

from perfbench.metrics import _spans


def read(r):
    return _spans.mean_ms("gcv.batcher.queue_wait")
