"""Dataset scoring under --net ed on the configuration's backbone (a Swin):
`Predictor(net="ed").predict_videos_stream` over host-resident face
batches, a few batches a call (so that the deadline is checked between
calls), cycled through a pool of distinct batches; the ED branch alone, so
nothing is drawn. The reference (`reference/swin.py`) scores a sample of
the window's launches from weights made again from the seed
(`reference/init_swin.py`).
"""

from __future__ import annotations

import time

import numpy as np

from perfbench.core import compare, trace
from perfbench.core import traffic as tg
from perfbench.core.cell import (Context, Outcome, Readings, dtype, free_device, kernel_plan,
                                 memory_peak)
from perfbench.core.groups import convnext_group
from perfbench.reference import swin as ref
from perfbench.reference.init import as_float32
from perfbench.reference.init_swin import make_state_dicts
from perfbench.reference.model import Operands, exact_float32


def swin_group(key: str) -> str:
    """The scoring path's kernel groups, with the Swin's window attention
    (K7) named."""
    if "window_attn_kernel" in key:
        return "K7 window_attn"
    return convnext_group(key)


def predictor(ctx: Context, sds):
    """The port's Predictor for net 'ed' on the configuration's backbone:
    no face detector, the configuration's kernel plan and dtype."""
    from genconvit_tpu_torch.config import Config, ModelConfig
    from genconvit_tpu_torch.infer.engine import Predictor

    cfg = ctx.cfg
    config = Config(img_size=cfg["img_size"], model=ModelConfig(backbone=cfg["backbone"]))
    return Predictor(config, net=cfg["net"], device=ctx.device, params=sds,
                     kernel_plan=kernel_plan(ctx), dtype=dtype(cfg), face_backend="fullframe",
                     backbone_classes=cfg["backbone_classes"])


def run(ctx: Context) -> Outcome:
    import torch
    from torch.profiler import record_function

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    wseed = tg.derive(ctx.seed, "weights")
    pool = tg.score_pool(mix, cfg, ctx.seed, dev)
    ctx.log(f"faces made: {len(pool)} batches")
    pred = predictor(ctx, make_state_dicts(cfg, wseed, dev, dtype(cfg)))
    free_device(torch)
    ctx.log("Predictor built (weights made, cast, folded)")
    per_call = mix["batches_per_call"]
    state = {"next": 0, "launches": 0}

    def call():
        ids = [(state["next"] + j) % len(pool) for j in range(per_call)]
        base = state["launches"]
        state["next"] += per_call
        state["launches"] += per_call
        with record_function("bench.stream_call"):
            out = pred.predict_videos_stream(pool[i] for i in ids)
        return base, ids, out

    for _ in range(mix["warmup_calls"]):
        call()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    ctx.log(f"set-up done: {state['launches']} warm-up launches")

    t_start = time.perf_counter()
    window = []
    while True:
        window.append(call())
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    t_end = time.perf_counter()
    seconds = t_end - t_start
    v = mix["videos_per_batch"]
    videos = len(window) * per_call * v
    ctx.log(f"window: {videos} videos in {len(window)} calls, {seconds:.3f} s")

    readings = Readings(ctx.cell, {"seconds": seconds, "videos": videos,
                                   "launches": len(window) * per_call})
    if ctx.trace:
        n = max(1, int(round(mix["trace_seconds"] * len(window) / seconds)))
        readings.trace = trace.traced(torch, lambda: [call() for _ in range(n)])
        readings.slice_units = {"forwards": n * per_call,
                                "frames_per_forward": v * cfg["num_frames"]}
        ctx.log(f"{n} calls: " + trace.describe(readings.trace))
    readings.memory_peak_bytes = memory_peak(torch, dev)

    # the sample, drawn from the seed among the window's launches
    launches = [(ids[j], out[j]) for _, ids, out in window for j in range(per_call)]
    pick = sorted(tg.rng(ctx.seed, "check").choice(len(launches),
                                                  size=min(ctx.wl["check_batches"], len(launches)),
                                                  replace=False))
    sample = [launches[i] for i in pick]
    del pred
    free_device(torch)

    t_ref = time.perf_counter()
    exact_float32()
    sds = as_float32(make_state_dicts(cfg, wseed, dev, dtype(cfg)))
    free_device(torch)
    ys, vals, means = [], [], []
    for pid, (y, y_val) in sample:
        frames, mask = (torch.from_numpy(a).to(dev) for a in pool[pid])
        m = ref.video_means(sds, frames, mask, cfg, chunk=mix["ref_chunk"])
        if ctx.fp8_control:
            y, y_val = compare.verdicts(ref.video_means(
                sds, frames, mask, cfg, chunk=mix["ref_chunk"], op=Operands("fp8")).cpu().numpy())
        ys.append(y)
        vals.append(y_val)
        means.append(m.cpu().numpy())
    numbers = compare.verdict_numbers(np.concatenate(ys), np.concatenate(vals),
                                      np.concatenate(means))
    ctx.log(compare.spread(np.concatenate(means)))
    ctx.log(f"reference: {len(sample)} launches, {len(sample) * v} videos in "
            f"{time.perf_counter() - t_ref:.1f} s")
    return Outcome({"videos_per_s": videos / seconds, "setup_s": t_start - ctx.t0},
                   attempted=videos, failed=0, checks=compare.held(numbers, ctx.wl["limits"]),
                   readings=readings, group=swin_group, numbers=numbers)
