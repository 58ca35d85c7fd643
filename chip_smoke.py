#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (genconvit_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):

  1. card identity: nvidia-smi's name and power limit;
  2. build: nvcc compiles csrc/ into build/ (first use only), with
     ptxas's register and spill report;
  3. kernels vs their plain PyTorch versions in bf16, at every shape the
     scoring path gives them (K1 at the 12 backbone-call x stage shapes,
     with the post-LN variant at stages 0-2, and with x = 0, where the
     output is the MLP branch alone; K2 at the three stem LNs); pass:
     max|diff| / max|ref| <= 3e-2 and every element within 2 bf16 ulps
     (both versions round at the same points); once per width, folds
     missing one term (fc2 bias, LN-bias fold, layer scale) must fail that
     check; CUDA-event times of both, and of the plain bf16 graph the
     kernel path replaces;
  4. the scoring path through the Predictor: net='genconvit',
     convnext_tiny, 224 px, 15 frames, random weights on the device from a
     seed, the real 25088x12544 VAE heads; V=1, V=2 with masked frames,
     V=8, predict_faces with k<F faces and with none; every forward must
     launch K1 54 times and K2 3 times;
  5. the bf16 kernel path vs the port's float32 plain path on the same
     weights (layer scale randomized, both heads' last layer scaled so
     that verdicts are decisive, deterministic VAE, TF32 off for the
     float32 pass): max|dy_val| <= 2e-2, equal y wherever the float32
     class means differ by more than 4e-2;
  6. throughput: videos/s and ms/launch at V=8 and V=1 on device-resident
     distinct inputs in rotating buffers, one sync per trial, and the V=1
     latency of a synchronized call;
  7. only with --profile: torch.profiler over 3 V=8 forwards, device time
     by kernel group and the device's busy share of the wall time.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

REL_TOL = 3e-2       # bf16 kernel vs plain, max|diff| relative to max|ref|
                     # (tools/onchip_parity.py:77 of the JAX package); the
                     # elementwise bound is km.ULP_TOL bf16 ulps
YVAL_TOL = 2e-2      # bf16 kernel path vs float32 plain path
DECISIVE = 4e-2      # class-mean gap above which y must agree
LOGIT_SCALE = 30.0   # phase 5 scales both heads' last layer by this
FRAMES = 15
IMG = 224
CALLS = (("ed", 240, 224), ("vae_x", 120, 224), ("vae_xhat", 120, 112))
DIMS = (96, 192, 384, 768)
DEPTHS = (3, 3, 9, 3)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = out.stdout.strip().splitlines()[0].strip()
    log(card)
    return card


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_block(torch, c: int, dev, g):
    """A block with realistic weights: timm init, then layer scale
    U(0.1, 1) (the 1e-6 init would make the comparison vacuous), LN affine
    and MLP biases off their trivial values."""
    from genconvit_tpu_torch.models.convnext import Block, ConvNeXt
    from genconvit_tpu_torch.models.init import init_convnext_

    holder = ConvNeXt(depths=(1,), dims=(c,), num_classes=1).to(dev)
    init_convnext_(holder, g)
    blk: Block = holder.stages[0].blocks[0]
    with torch.no_grad():
        blk.gamma.uniform_(0.1, 1.0, generator=g)
        blk.norm.weight.add_(0.1 * torch.randn(c, device=dev, generator=g))
        blk.norm.bias.copy_(0.1 * torch.randn(c, device=dev, generator=g))
        blk.mlp.fc1.bias.copy_(0.02 * torch.randn(4 * c, device=dev, generator=g))
        blk.mlp.fc2.bias.copy_(0.02 * torch.randn(c, device=dev, generator=g))
    return blk.to(torch.bfloat16).to(memory_format=torch.channels_last)


def compare(torch, km, what: str, out, ref, x=None, scale=None) -> tuple:
    """Kernel output vs its plain version: finite, max|diff| / max|ref| <=
    REL_TOL, and every element within km.ULP_TOL bf16 ulps
    (km.bf16_ulp_error with the residual input x and the scale floor)."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    ulps = km.bf16_ulp_error(out, ref, x, scale)
    if not (torch.isfinite(out).all() and rel <= REL_TOL and ulps <= km.ULP_TOL):
        raise AssertionError(f"{what}: max|diff| {err:.3e}, /max|ref| {rel:.3e} "
                             f"(limit {REL_TOL}), {ulps} bf16 ulps (limit {km.ULP_TOL})")
    return err, rel, ulps


def must_fail(torch, km, what: str, out, ref, x=None, scale=None) -> str:
    """A planted fault: the check must refuse it."""
    torch.cuda.synchronize()
    rel = (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
    ulps = km.bf16_ulp_error(out, ref, x, scale)
    if ulps <= km.ULP_TOL:
        raise AssertionError(f"planted fault {what} passed the check ({ulps} ulps)")
    return f"{what}: {ulps:.1f} ulps, rel {rel:.2e} -> refused"


def planted_folds(torch, km, blk) -> dict:
    """The block's folds, each missing one term of K1's math, as a kernel
    that forgot it would compute."""
    args = dict(ln_scale=blk.norm.weight, ln_bias=blk.norm.bias,
                fc1_weight=blk.mlp.fc1.weight, fc1_bias=blk.mlp.fc1.bias,
                fc2_weight=blk.mlp.fc2.weight, fc2_bias=blk.mlp.fc2.bias,
                gamma=blk.gamma)
    faults = {}
    for name, key, value in (("fc2 bias dropped", "fc2_bias", 0.0),
                             ("LN bias fold dropped", "ln_bias", 0.0),
                             ("layer scale dropped", "gamma", 1.0)):
        a = dict(args, **{key: torch.full_like(args[key], value)})
        faults[name] = km.fold_block_mlp(**a, dtype=torch.bfloat16)
    return faults


def phase_kernels(torch, dev, card: str) -> list:
    import torch.nn.functional as F

    from genconvit_tpu_torch.models.convnext import _nhwc
    from genconvit_tpu_torch.ops.act import gelu
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
    from genconvit_tpu_torch.ops.norm import layer_norm

    g = torch.Generator(device=dev).manual_seed(1234)
    k1_ms = k1_plain_ms = k1_graph_ms = 0.0
    k1_err = 0.0
    for call, n, px in CALLS:
        for si, c in enumerate(DIMS):
            h = (px // 4) >> si  # 56/28/14/7 at 224 px, 28/14/7/3 at 112
            blk = random_block(torch, c, dev, g)
            x = torch.randn(n, c, h, h, device=dev, generator=g).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            with torch.inference_mode():
                d = blk.dw(x)
                dr, xr = _nhwc(d), _nhwc(x)
                folded = blk.fold()
                rows = dr.numel() // c
                ragged = int(rows % km.row_tile(c) != 0)
                # x = 0: the output is bf16(o), the MLP branch alone
                zero = torch.zeros_like(xr)
                o_max = km.ln_mlp_residual_plain(dr, zero, folded).float().abs().max().item()
                post_variants = [None]
                if si < 3:
                    post_variants.append((
                        (1 + 0.1 * torch.randn(c, device=dev, generator=g)).float(),
                        (0.1 * torch.randn(c, device=dev, generator=g)).float()))
                tiers = ("default", "hp") if (call, si) == ("ed", 1) else ("default",)
                for post in post_variants:
                    for tier in tiers:
                        for xin in (xr, zero):
                            what = (f"K1 {call:8s} s{si} R={rows:7d} C={c:3d} "
                                    f"post_ln={int(post is not None)} gelu={tier:7s} "
                                    f"x={'0' if xin is zero else 'randn'}")
                            ref = km.ln_mlp_residual_plain(dr, xin, folded, post, tier)
                            out = km.ln_mlp_residual(dr, xin, folded, post, tier)
                            if post is None:   # out = x + bf16(o)
                                err, rel, ulps = compare(torch, km, what, out, ref, xin, o_max)
                            else:              # out = LN(x + o): the output's own scale
                                err, rel, ulps = compare(torch, km, what, out, ref, None,
                                                         ref.float().abs().max().item())
                            k1_err = max(k1_err, err)
                            log(f"{what} ragged={ragged} max|diff|={err:.3e} "
                                f"rel={rel:.3e} ulps={ulps:.3f}")
                if call == "ed":  # once per width: the check refuses a wrong MLP
                    for xin in (xr, zero):
                        ref = km.ln_mlp_residual_plain(dr, xin, folded)
                        for name, bad in planted_folds(torch, km, blk).items():
                            out = km.ln_mlp_residual(dr, xin, bad)
                            log(f"  C={c} planted, x={'0' if xin is zero else 'randn'}: "
                                + must_fail(torch, km, name, out, ref, xin, o_max))
                del ref, out, zero

                def graph_tail():
                    t = layer_norm(dr, blk.norm.weight, blk.norm.bias, 1e-6)
                    t = gelu(F.linear(t, blk.mlp.fc1.weight, blk.mlp.fc1.bias))
                    t = F.linear(t, blk.mlp.fc2.weight, blk.mlp.fc2.bias)
                    return xr + t * blk.gamma

                iters = 20 if rows * c < 2e7 else 10
                t_k = cuda_ms(torch, lambda: km.ln_mlp_residual(dr, xr, folded), iters)
                t_p = cuda_ms(torch, lambda: km.ln_mlp_residual_plain(dr, xr, folded), iters)
                t_g = cuda_ms(torch, graph_tail, iters)
            log(f"K1 time {call:8s} s{si} R={rows:7d} C={c:3d}: kernel {t_k:.4f} ms, "
                f"plain {t_p:.4f} ms, plain bf16 graph {t_g:.4f} ms [{card}]")
            k1_ms += DEPTHS[si] * t_k
            k1_plain_ms += DEPTHS[si] * t_p
            k1_graph_ms += DEPTHS[si] * t_g
            del blk, x, d, dr, xr, folded
    log(f"K1 per V=8 ensemble forward (54 launches, depth-weighted): kernel "
        f"{k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, plain bf16 graph "
        f"{k1_graph_ms:.4f} ms [{card}]")

    k2_ms = k2_plain_ms = 0.0
    k2_err = 0.0
    for call, n, px in CALLS:
        h, c = px // 4, DIMS[0]
        x = (3 * torch.randn(n, h, h, c, device=dev, generator=g) + 0.5).to(torch.bfloat16)
        s = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).float()
        b = (0.1 * torch.randn(c, device=dev, generator=g)).float()
        ref = km.layer_norm_rows_plain(x, s, b)
        out = km.layer_norm_rows(x, s, b)
        err, rel, ulps = compare(torch, km, f"K2 {call}", out, ref)
        k2_err = max(k2_err, err)
        if call == "ed":
            log("  K2 planted, " + must_fail(torch, km, "LN bias dropped",
                                             km.layer_norm_rows(x, s, 0 * b), ref))
        t_k = cuda_ms(torch, lambda: km.layer_norm_rows(x, s, b), 20)
        t_p = cuda_ms(torch, lambda: km.layer_norm_rows_plain(x, s, b), 20)
        k2_ms += t_k
        k2_plain_ms += t_p
        log(f"K2 {call:8s} R={x.numel() // c:7d} C={c}: max|diff|={err:.3e} "
            f"rel={rel:.3e} ulps={ulps:g}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms [{card}]")
    log(f"K2 per V=8 ensemble forward (3 launches): kernel {k2_ms:.4f} ms, "
        f"plain {k2_plain_ms:.4f} ms [{card}]")
    return [
        {"name": "ln_mlp_residual", "route": "cuda",
         "source": "genconvit_tpu_torch/csrc/convnext_mlp.cu",
         "replaces": "genconvit_tpu/ops/pallas/convnext_mlp.py:74",
         "launches": 0, "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "layer_norm_rows", "route": "cuda",
         "source": "genconvit_tpu_torch/csrc/convnext_mlp.cu",
         "replaces": "genconvit_tpu/ops/pallas/convnext_mlp.py:244",
         "launches": 0, "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]


def check_verdicts(np, y, y_val, v: int) -> None:
    if y.shape != (v,) or y_val.shape != (v,):
        raise AssertionError(f"verdict shapes {y.shape}, {y_val.shape} != ({v},)")
    if not np.all(np.isfinite(y_val)):
        raise AssertionError(f"non-finite y_val {y_val}")
    if not (np.isin(y, (0, 1)).all() and (y_val >= 0).all() and (y_val <= 1).all()):
        raise AssertionError(f"verdicts out of range: y={y} y_val={y_val}")


def phase_slice(torch, np, dev, card: str):
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km

    t0 = time.perf_counter()
    pred = Predictor(net="genconvit", device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"slice: Predictor (random init on device, bf16, folds) "
        f"{time.perf_counter() - t0:.2f} s; plan {pred.kernel_plan}")
    rng = np.random.default_rng(0)

    def frames(v):
        return rng.integers(0, 256, (v, FRAMES, IMG, IMG, 3), dtype=np.uint8)

    mask2 = np.ones((2, FRAMES), np.float32)
    mask2[0, 10:] = 0
    mask2[1, 3:] = 0
    requests = [
        ("V=1", 1, lambda: pred.predict_videos_batched(frames(1), np.ones((1, FRAMES), np.float32))),
        ("V=2 masked", 2, lambda: pred.predict_videos_batched(frames(2), mask2)),
        ("V=8", 8, lambda: pred.predict_videos_batched(frames(8), np.ones((8, FRAMES), np.float32))),
        ("faces k=7", 1, lambda: tuple(np.array([r]) for r in pred.predict_faces(frames(1)[0, :7], FRAMES))),
    ]
    km.reset_launch_counts()
    for name, v, fn in requests:
        before = km.launch_counts()
        t = time.perf_counter()
        y, y_val = fn()
        dt = time.perf_counter() - t
        after = km.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        log(f"slice {name}: y={y.tolist()} y_val={np.round(y_val, 5).tolist()} "
            f"({dt:.2f} s, launches {got})")
        check_verdicts(np, np.asarray(y), np.asarray(y_val, np.float64), v)
        if got != {"ln_mlp_residual": 54, "layer_norm_rows": 3}:
            raise AssertionError(f"{name}: kernel launches {got}, want 54 K1 and 3 K2")
    totals = km.launch_counts()
    empty = pred.predict_faces(np.zeros((0, IMG, IMG, 3), np.uint8), FRAMES)
    if empty != (0, 0.5) or km.launch_counts() != totals:
        raise AssertionError(f"zero faces gave {empty}, launches {km.launch_counts()}")
    log(f"slice: zero faces -> {empty}; main-path launches {totals} over "
        f"{len(requests)} forwards")
    return pred, totals


def phase_parity(torch, np, dev, card: str) -> None:
    from genconvit_tpu_torch.infer.aggregate import masked_prob_sums
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.models.convnext import Block

    base = Predictor(net="genconvit", device=dev, seed=1, dtype=torch.float32,
                     deterministic_vae=True)
    g = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for m in base.model.modules():
            if isinstance(m, Block):
                m.gamma.uniform_(0.1, 1.0, generator=g)
        # random heads keep both class means within 1e-2 of 0.5, where no
        # verdict is decisive; scaled logits give the y check videos to test
        for branch in base.model.branches():
            branch.fc2.weight.mul_(LOGIT_SCALE)
            branch.fc2.bias.mul_(LOGIT_SCALE)
    p16 = Predictor(net="genconvit", device=dev, params=base.state_dicts(),
                    deterministic_vae=True)
    v = 4
    fr = torch.randint(0, 256, (v, FRAMES, IMG, IMG, 3), dtype=torch.uint8,
                       device=dev, generator=g)
    mask = torch.ones(v, FRAMES, device=dev)
    mask[1, 8:] = 0
    mask[3, 2:] = 0

    def means(p):
        sums, count = masked_prob_sums(*p.video_logits(fr, mask))
        return (sums / count.clamp(min=1)[:, None]).double().cpu().numpy()

    def verdicts(m):
        y = m.argmax(-1)
        y_val = np.where(m[:, 0] > m[:, 1], m[:, 0], np.abs(1 - m[:, 1]))
        return y, y_val

    m16 = means(p16)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m32 = means(base)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    y16, v16 = verdicts(m16)
    y32, v32 = verdicts(m32)
    dyv = float(np.abs(v16 - v32).max())
    decisive = np.abs(m32[:, 0] - m32[:, 1]) > DECISIVE
    log(f"parity bf16 kernels vs f32 plain: class means bf16 {np.round(m16, 5).tolist()} "
        f"f32 {np.round(m32, 5).tolist()}")
    log(f"parity: max|dy_val| = {dyv:.3e} (limit {YVAL_TOL}); decisive videos "
        f"{int(decisive.sum())}/{v}, y bf16 {y16.tolist()} f32 {y32.tolist()} [{card}]")
    if not dyv <= YVAL_TOL:
        raise AssertionError(f"max|dy_val| {dyv} > {YVAL_TOL}")
    if not decisive.any():
        raise AssertionError("no decisive video: the y check would test nothing")
    if not (y16[decisive] == y32[decisive]).all():
        raise AssertionError("y differs on a decisive video")


def phase_throughput(torch, pred, dev, card: str) -> None:
    g = torch.Generator(device=dev).manual_seed(3)

    def run(v: int, iters: int, trials: int = 3):
        bufs = [torch.randint(0, 256, (v, FRAMES, IMG, IMG, 3), dtype=torch.uint8,
                              device=dev, generator=g) for _ in range(4)]
        mask = torch.ones(v, FRAMES, device=dev)
        for i in range(2):
            pred.forward_batched(bufs[i], mask)
        torch.cuda.synchronize()
        rates = []
        for _ in range(trials):
            t0 = time.perf_counter()
            for i in range(iters):
                pred.forward_batched(bufs[i % 4], mask)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rates.append((v * iters / dt, dt / iters * 1e3))
            log(f"throughput V={v}: {rates[-1][0]:.2f} videos/s, "
                f"{rates[-1][1]:.2f} ms/launch [{card}]")
        return bufs, mask, rates

    torch.cuda.reset_peak_memory_stats(dev)
    _, _, r8 = run(8, 6)
    best = max(r8)
    log(f"throughput V=8 best: {best[0]:.2f} videos/s, {best[1]:.2f} ms/launch; "
        f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB [{card}]")
    bufs, mask, r1 = run(1, 24)
    lat = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, y_val = pred.forward_batched(bufs[i % 4], mask)
        y_val.cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    log(f"latency V=1: pipelined best {max(r1)[1]:.2f} ms/launch; synchronized "
        f"call median {lat[len(lat) // 2]:.2f} ms, min {lat[0]:.2f} ms [{card}]")


def phase_profile(torch, pred, dev, card: str, n: int = 3) -> None:
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(5)
    bufs = [torch.randint(0, 256, (8, FRAMES, IMG, IMG, 3), dtype=torch.uint8,
                          device=dev, generator=g) for _ in range(2)]
    mask = torch.ones(8, FRAMES, device=dev)
    for i in range(3):
        pred.forward_batched(bufs[i % 2], mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            pred.forward_batched(bufs[i % 2], mask)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    events = prof.key_averages()

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        return us / n / 1e3

    def group(key):
        k = key.lower()
        if "ln_mlp_residual" in k:
            return f"K1 {key}"  # one template instance per row tile
        if "layer_norm_rows" in k:
            return "K2 layer_norm_rows"
        if ("gemm" in k or "nvjet" in k) and "conv" not in k:
            return "GEMM (latent head, heads)"
        if "conv2d_c1_k1" in k:
            return "depthwise 7x7 (cuDNN)"
        if any(s in k for s in ("conv", "xmma", "implicit", "cudnn", "fprop", "cutlass")):
            return "other convolutions (cuDNN)"
        return "elementwise and other"

    groups: dict = {}
    for e in events:  # device kernels, not the aten ops that launch them
        if dev_ms(e) > 0 and not e.key.startswith("aten::"):
            groups.setdefault(group(e.key), []).append((dev_ms(e), e.count // n, e.key))
    busy = sum(t for members in groups.values() for t, _, _ in members)
    if busy <= 0:
        raise AssertionError("profiler recorded no device time")
    log(f"profile V=8 forward: {wall:.2f} ms/launch under the profiler, device "
        f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%) [{card}]")
    for name, members in sorted(groups.items(), key=lambda kv: -sum(m[0] for m in kv[1])):
        t = sum(m[0] for m in members)
        log(f"  {t:9.3f} ms {100 * t / busy:5.1f}%  {sum(m[1] for m in members):4d} "
            f"launches  {name}")
    for t, count, key in sorted(groups.get("elementwise and other", []), reverse=True)[:4]:
        log(f"    of which {t:7.3f} ms {count:4d} launches  {key[:110]}")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 7, the profiler's device-time breakdown")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from genconvit_tpu_torch.ops.cuda import _build
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = phase_identity()
    info = _build.build()
    log(f"build: {info.seconds:.1f} s -> {info.path}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"K1 row tiles: {{C: rows}} = {{{', '.join(f'{c}: {km.row_tile(c)}' for c in DIMS)}}}")
    kernels = phase_kernels(torch, dev, card)
    pred, totals = phase_slice(torch, np, dev, card)
    phase_parity(torch, np, dev, card)
    phase_throughput(torch, pred, dev, card)
    if args.profile:
        phase_profile(torch, pred, dev, card)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_all:.1f} s [{card}]")
    for k in kernels:
        k["launches"] = totals[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
