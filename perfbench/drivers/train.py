"""Training one branch of GenConViT: `train.loop.make_train_step` driven as
`train_model` drives it, one step a batch of host uint8 images and labels
uploaded per step, eps drawn from the run's seed per step and passed in,
and the loss fetched after every step. The loader's decode and
augmentation are left out.

Set-up builds the one model and optimizer, then runs the first three steps
through the same call and feed as the window, on three distinct batches,
reading what the comparison needs on the way: each step's loss, the first
gradient as Adam took it (its first moment after one step over 1 - beta1)
and, after the third step, how far each leaf moved. The window then goes
on with the same objects. The reference repeats the three steps in
float32 from the same weights, batches and eps once the window has closed.
"""

from __future__ import annotations

import time
from typing import Dict

from perfbench.core import compare, trace
from perfbench.core import traffic as tg
from perfbench.core.cell import (Context, Outcome, Readings, dtype, free_device, kernel_plan,
                                 memory_peak, port_config)
from perfbench.core.groups import train_group
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train
from perfbench.reference.init import make_state_dicts

CHECKED_STEPS = 3
BETA1 = 0.9


def _norms(torch, tensors: Dict[str, "torch.Tensor"], scale: float = 1.0) -> Dict[str, float]:
    keys = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].float()) for k in keys]) * scale
    return dict(zip(keys, vals.tolist()))


def _reference(torch, cfg, wseed, dev, net, mix, images, labels, eps, keys, op):
    """The float32 reference's first steps from the benchmark's weights
    (products from `op`'s operands): (losses, the first gradient's norms as
    Adam takes them, the same without the decay term, each leaf's change)."""
    sd = make_state_dicts(cfg, wseed, dev, torch.float32, branches=(net,))[net]
    start = {k: v.clone() for k, v in sd.items() if v.is_floating_point()}
    trainer = ref_train.Trainer(sd, mix["learning_rate"], mix["weight_decay"], op)
    losses, taken, raw = [], {}, {}
    for i in range(CHECKED_STEPS):
        loss, t, r = trainer.step(torch.from_numpy(images[i]).to(dev),
                                  torch.from_numpy(labels[i]).to(dev), eps[i], cfg)
        losses.append(loss)
        if i == 0:
            taken, raw = t, r
    moved = ref_train.change_norms(trainer.sd, start, keys)
    del trainer, sd, start
    free_device(torch)
    return losses, taken, raw, moved


def run(ctx: Context) -> Outcome:
    import torch
    from genconvit_tpu_torch.models.genconvit import GenConViT
    from genconvit_tpu_torch.train import loop, optim

    cfg, mix, wl, dev = ctx.cfg, ctx.mix, ctx.wl, ctx.device
    net, b = mix["net"], mix["batch"]
    wseed = tg.derive(ctx.seed, "weights")
    images, labels = tg.train_pool(mix, cfg, ctx.seed, dev)
    sd = make_state_dicts(cfg, wseed, dev, torch.float32, branches=(net,))[net]
    with torch.device("meta"):
        model = GenConViT(port_config(cfg), net, cfg["backbone_classes"])
    model = model.to_empty(device=dev)
    getattr(model, net).load_state_dict(sd)
    del sd
    model = model.to(memory_format=torch.channels_last)
    optimizer = optim.make_optimizer(model.parameters(), mix["learning_rate"], mix["weight_decay"])
    step = loop.make_train_step(model, net, optimizer, mix["use_kl"], dtype(cfg), kernel_plan(ctx))
    ctx.log("model, optimizer and step built")
    g = torch.Generator(device=dev).manual_seed(tg.derive(ctx.seed, "eps"))
    state = {"i": 0}
    eps_used = []

    def one() -> float:
        i = state["i"]
        state["i"] += 1
        x = torch.from_numpy(images[i % len(images)]).to(dev)
        y = torch.from_numpy(labels[i % len(labels)]).to(dev)
        eps = torch.randn((b, cfg["latent_dims"]), generator=g, device=dev,
                          dtype=torch.float32).to(dtype(cfg))
        if i < CHECKED_STEPS:
            eps_used.append(eps)
        loss, _ = step(x, y, eps)
        return float(loss)

    # the first steps, read for the comparison: the same call and feed as the window
    prefix = f"{net}."
    leaves = {n[len(prefix):]: p for n, p in model.named_parameters()}
    stats = {n[len(prefix):]: t for n, t in model.named_buffers() if ref_train.is_bn_stat(n)}
    start = {k: t.detach().cpu().clone() for k, t in {**leaves, **stats}.items()}
    losses = [one()]
    first_grad = _norms(torch, {k: optimizer.state[p]["exp_avg"] for k, p in leaves.items()},
                        1.0 / (1.0 - BETA1))
    losses += [one() for _ in range(CHECKED_STEPS - 1)]
    moved = {k: torch.linalg.vector_norm(t.detach().float() - start[k].to(dev)).item()
             for k, t in {**leaves, **stats}.items()}
    del start
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    ctx.log(f"set-up done: {CHECKED_STEPS} steps, losses {losses}")

    t_start = time.perf_counter()
    steps = 0
    while True:
        one()
        steps += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    seconds = time.perf_counter() - t_start
    ctx.log(f"window: {steps} steps of {b} in {seconds:.3f} s")
    readings = Readings(ctx.cell, {"seconds": seconds, "images": steps * b, "steps": steps})
    if ctx.trace:
        n = max(1, int(round(mix["trace_seconds"] * steps / seconds)))
        readings.trace = trace.traced(torch, lambda: [one() for _ in range(n)])
        readings.slice_units = {"steps": n}
        ctx.log(f"{n} steps: " + trace.describe(readings.trace))
    readings.memory_peak_bytes = memory_peak(torch, dev)
    eps_ref = [e.float() for e in eps_used]
    del model, optimizer, step, leaves, stats
    free_device(torch)

    t_ref = time.perf_counter()
    ref.exact_float32()
    ref_losses, ref_grad, ref_raw, ref_moved = _reference(
        torch, cfg, wseed, dev, net, mix, images, labels, eps_ref, list(moved), ref.EXACT)
    if ctx.fp8_control:   # the reference from float8 operands in the program's place
        losses, first_grad, _, moved = _reference(
            torch, cfg, wseed, dev, net, mix, images, labels, eps_ref, list(moved),
            ref.Operands("fp8"))
    counted = compare.moved_leaves(ref_raw, wl["limits"]["still_leaf"])
    counted += [k for k in moved if ref_train.is_bn_stat(k)]
    grad_gap, grad_at = compare.worst_leaf_gap(first_grad, ref_grad, ref_grad)
    move_gap, move_at = compare.worst_leaf_gap(moved, ref_moved, counted)
    still = sorted(set(ref_raw) - set(counted))
    ctx.log(f"reference: {CHECKED_STEPS} steps in {time.perf_counter() - t_ref:.1f} s; losses "
            f"{ref_losses}; worst gradient leaf {grad_at}, worst moved leaf {move_at}; "
            f"left out as still: {still}")
    numbers = {"loss_gap": compare.rel_gaps(losses, ref_losses),
               "grad_gap": grad_gap, "change_gap": move_gap}
    return Outcome({"train_images_per_s": steps * b / seconds, "setup_s": t_start - ctx.t0},
                   attempted=steps, failed=0, checks=compare.held(numbers, wl["limits"]),
                   readings=readings, group=train_group, numbers=numbers)
