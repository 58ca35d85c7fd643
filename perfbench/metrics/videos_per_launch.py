"""videos_per_launch.*: MicroBatcher.batched_videos / launches, the
counters' growth over the untraced window."""


def read(r):
    launches = r.window.get("launches")
    return r.window["batched_videos"] / launches if launches else None
