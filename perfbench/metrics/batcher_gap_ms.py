"""batcher_gap_ms.*: the batcher's worker's ms a launch outside any forward
of its own: the self time of its window sleep, its drain and its delivery
of the verdicts (spans gcv.batcher.window, .drain, .deliver) over the
count of its fetches (gcv.batcher.fetch, one a launch)."""

from perfbench.metrics import _spans

PARTS = ("gcv.batcher.window", "gcv.batcher.drain", "gcv.batcher.deliver")


def read(r):
    t = _spans.table()
    fetch = t.get("gcv.batcher.fetch")
    if not fetch or not fetch["count"] or not any(p in t for p in PARTS):
        return None
    return 1e3 * sum(t[p]["self_s"] for p in PARTS if p in t) / fetch["count"]
