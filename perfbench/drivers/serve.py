"""A moderation upload queue: independent uploads, each one
`MicroBatcher.submit` of its host-resident face crops [k, S, S, 3], sent
open loop on a Poisson schedule at the cell's fixed rate, each from a
client thread of its own. The end-to-end rate is the videos whose verdicts
came back over the seconds from the window's start to the last verdict: the
schedule ends with the window, and a backlog left then is drained and
counted. Latency (per layer) runs from the moment a request was due to its
verdict in the client; above the batcher's capacity it holds the backlog's
wait, and the client threads' too. Decode and detection are left out: every
request hands over faces.

The VAE runs deterministic (z = mu): which drain a request joins, and so
which draws it would take, is the batcher's own business.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import time

import numpy as np

from perfbench.core import compare, trace
from perfbench.core import traffic as tg
from perfbench.core.cell import (Context, Outcome, Readings, dtype, free_device, memory_peak,
                                 predictor)
from perfbench.core.groups import convnext_group
from perfbench.reference import model as ref
from perfbench.reference.init import as_float32, make_state_dicts

LATE_WAIT_S = 60.0   # a verdict may come this long after the window closes


def _percentile(values, q: float) -> float:
    """The q-th percentile (nearest rank) of values; inf counts as a miss."""
    xs = sorted(values)
    return xs[max(0, int(math.ceil(q / 100.0 * len(xs))) - 1)]


def _behind(due: np.ndarray, lat) -> dict:
    """How far a run fell behind its schedule: requests completed per second
    of the run, and the median latency of the requests due in each half."""
    done = [d + x for d, x in zip(due, lat) if math.isfinite(x)]
    half = len(lat) // 2
    return {"completed_per_s": len(done) / max(max(done, default=0.0), 1e-9),
            "p50_first_half_ms": 1e3 * _percentile(lat[:half] or lat, 50),
            "p50_second_half_ms": 1e3 * _percentile(lat[half:], 50)}


class _Client:
    """Sends a schedule's requests from a thread pool and records, per
    request, how late the sender handed it to the pool, its latency from its
    due time (a wait for a free client thread included) and its verdict."""

    def __init__(self, batcher, uploads: np.ndarray, workers: int):
        self.batcher = batcher
        self.uploads = uploads
        self.pool = cf.ThreadPoolExecutor(max_workers=workers, thread_name_prefix="client")

    def _one(self, t_due: float, late: float, faces: np.ndarray):
        try:
            verdict = self.batcher.submit(faces)
        except Exception as e:   # a failed request counts as a miss; the run goes on
            return late, math.inf, None, repr(e)
        return late, time.perf_counter() - t_due, verdict, None

    def run(self, due: np.ndarray, frames: np.ndarray, which: np.ndarray):
        """Send every request at its due time; wait for all of them."""
        t0 = time.perf_counter()
        futs = []
        for d, k, w in zip(due, frames, which):
            t_due = t0 + float(d)
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futs.append(self.pool.submit(self._one, t_due, time.perf_counter() - t_due,
                                         self.uploads[w][:k]))
        done, _ = cf.wait(futs, timeout=max(0.0, t0 + float(due[-1]) + LATE_WAIT_S
                                            - time.perf_counter()))
        out = []
        for f in futs:
            out.append(f.result() if f in done else (math.nan, math.inf, None, "no verdict"))
        return t0, out

    def close(self) -> None:
        self.pool.shutdown(wait=True)


def run(ctx: Context) -> Outcome:
    import torch
    from genconvit_tpu_torch.infer.batcher import MicroBatcher

    cfg, mix, wl, dev = ctx.cfg, ctx.mix, ctx.wl, ctx.device
    f = cfg["num_frames"]
    wseed = tg.derive(ctx.seed, "weights")
    uploads = tg.upload_pool(mix, cfg, ctx.seed, dev)
    ctx.log(f"faces made: {len(uploads)} uploads")
    pred = predictor(ctx, make_state_dicts(cfg, wseed, dev, dtype(cfg)), 0, deterministic=True)
    free_device(torch)
    ctx.log("Predictor built (weights made, cast, folded)")
    batcher = MicroBatcher(pred, f, window_ms=mix["window_ms"], max_batch=mix["max_batch"])
    client = _Client(batcher, uploads, mix["client_threads"])
    try:
        # warm-up: drains of every size, 1 to max_batch, twice
        for size in list(range(1, mix["max_batch"] + 1)) * 2:
            futs = [client.pool.submit(batcher.submit, uploads[i % len(uploads)])
                    for i in range(size)]
            for fu in futs:
                fu.result()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        ctx.log(f"set-up done: {batcher.launches} warm-up launches")
        launches0, videos0 = batcher.launches, batcher.batched_videos
        due, frames, which = tg.serve_schedule(mix, cfg, wl["rate_per_s"], ctx.seconds, ctx.seed)
        t_start = time.perf_counter()
        _, results = client.run(due, frames, which)
        seconds = max(time.perf_counter() - t_start, ctx.seconds)
        launches = batcher.launches - launches0
        batched = batcher.batched_videos - videos0
        lat = [r[1] for r in results]
        late = [r[0] for r in results if not math.isnan(r[0])]
        failed = sum(1 for r in results if r[2] is None)
        ctx.log(f"window: {len(results)} requests due over {due[-1]:.3f} s at "
                f"{wl['rate_per_s']}/s, {failed} failed, {launches} launches, "
                f"{batched / max(launches, 1):.3f} videos a launch")
        ctx.log(f"generator lateness: median {1e3 * _percentile(late, 50):.3f} ms, p99 "
                f"{1e3 * _percentile(late, 99):.3f} ms, max {1e3 * max(late):.3f} ms")
        served = len(results) - failed
        p50, p95 = 1e3 * _percentile(lat, 50), 1e3 * _percentile(lat, 95)
        ctx.log(f"served {served} videos in {seconds:.3f} s: {served / seconds:.4f} videos/s; "
                f"latency p50 {p50:.2f} ms, p95 {p95:.2f} ms")
        readings = Readings(ctx.cell, {"seconds": seconds, "requests": len(results),
                                       "videos": served, "launches": launches,
                                       "batched_videos": batched, "latency_p50_ms": p50,
                                       "latency_p95_ms": p95, "sweep": _behind(due, lat)})
        if ctx.trace:
            n = max(1, int(round(wl["rate_per_s"] * mix["trace_seconds"])))
            tdue, tframes, twhich = tg.serve_schedule(mix, cfg, wl["rate_per_s"],
                                                      mix["trace_seconds"], ctx.seed + 1)
            readings.trace = trace.traced(torch, lambda: client.run(tdue[:n], tframes[:n],
                                                                    twhich[:n]))
            readings.slice_units = {"requests": n}
            ctx.log(f"{n} requests: " + trace.describe(readings.trace))
        readings.memory_peak_bytes = memory_peak(torch, dev)
    finally:
        batcher.close()
        client.close()
    del batcher, pred, client
    free_device(torch)

    # the sample: drawn from the seed among the requests that got a verdict
    ok = [i for i, r in enumerate(results) if r[2] is not None]
    pick = sorted(tg.rng(ctx.seed, "check").choice(
        len(ok), size=min(wl["check_requests"], len(ok)), replace=False)) if ok else []
    sample = [ok[i] for i in pick]
    t_ref = time.perf_counter()
    ref.exact_float32()
    sds = as_float32(make_state_dicts(cfg, wseed, dev, dtype(cfg)))
    free_device(torch)
    s = cfg["img_size"]
    means, fp8 = [], []
    chunk = mix["ref_chunk"]
    for a in range(0, len(sample), chunk):
        part = sample[a:a + chunk]
        batch = np.zeros((len(part), f, s, s, 3), np.uint8)
        mask = np.zeros((len(part), f), np.float32)
        for j, i in enumerate(part):
            k = int(frames[i])
            batch[j, :k] = uploads[which[i]][:k]
            mask[j, :k] = 1.0
        batch, mask = torch.from_numpy(batch).to(dev), torch.from_numpy(mask).to(dev)
        means.append(ref.video_means(sds, batch, mask, cfg, None, chunk=chunk).cpu().numpy())
        if ctx.fp8_control:
            fp8.append(ref.video_means(sds, batch, mask, cfg, None, chunk=chunk,
                                       op=ref.Operands("fp8")).cpu().numpy())
    y = np.array([results[i][2][0] for i in sample], np.int64)
    y_val = np.array([results[i][2][1] for i in sample], np.float64)
    if ctx.fp8_control and fp8:
        y, y_val = compare.verdicts(np.concatenate(fp8))
    numbers = compare.verdict_numbers(y, y_val, np.concatenate(means) if means else
                                      np.zeros((0, 2)))
    numbers["failed_requests"] = float(failed)
    if means:
        ctx.log(compare.spread(np.concatenate(means)))
    ctx.log(f"reference: {len(sample)} requests in {time.perf_counter() - t_ref:.1f} s")
    e2e = {"videos_per_s": served / seconds, "setup_s": t_start - ctx.t0}
    return Outcome(e2e, attempted=len(results), failed=failed,
                   checks=compare.held(numbers, wl["limits"]), readings=readings,
                   group=convnext_group, numbers=numbers)
