"""K1, K4, K5, K6, K3, K7, K2 and the probes M1, M2 and M3 of one checkout of
the port, timed on the card, so that two checkouts (a change and its
parent) can be compared on one card:

    python3 genconvit_tpu_torch/tools/kernel_ab.py [--package-dir DIR] [--ptxas]
        [--only k1k4,k5k6,k3,k7,k2,m1m2,m3,k1,swin]

DIR holds the genconvit_tpu_torch package to load (default: this checkout);
unpack the parent with `git archive HEAD genconvit_tpu_torch` into a
directory that .gitignore lists, and run parent, change, change, parent.
Prints CUDA-event ms per launch of K1 (ln_mlp_residual) and of K4
(ln_mlp_residual_int8, 'fc1' and 'full') at the 12 block-tail shapes of a
V=8 convnext_tiny ensemble forward and their depth-weighted sums, of K5
(fused_convnext_block) at its 5 shapes of that forward (x depth: 15
launches) and of K6 (fused_convnext_stage) at its 5 chains, with their
per-forward sums, of K3 (matmul_wint8) on the 25088 x 12544 latent head
at M = 15, 30, 120 beside F.linear on the bf16 head, of K7
(window_attention) at the stage shapes of swin_tiny and swin_large at
N = 120, masked and unmasked, with their per-forward sums (x the blocks of
each shape), and of K2 (layer_norm_rows) at the three stem LNs of a V=8
forward at convnext_tiny's C = 96 and convnext_large's C = 192, with their
per-forward sums, and of the probes (m1m2): M1 (dots_bf16, dots_int8) at
K4's 12 shapes (hid = 4C; per forward: x depth) and at convnext_large's
four stage widths and convnext_base's 1024 at the ED call's rows, M2
(block_parts) at its 7 phases with the deltas between them and K5 on the
same pack at K5's 5 shapes (per forward: x depth), and (m3) M3
(dw_moments) at the JAX tool's default (240 x 56^2 x 96), at the 7 shapes
of the LN-folded blocks under pallas='1' (per forward: x depth, 39
launches) and at convnext_base's and convnext_large's widest LN-folded
shapes at the ED call's rows, with the kernel's device time from
torch.profiler beside the events' time, beside cuDNN's depthwise conv and
the two reductions and the bound with only the taps inside the image
counted (m3_bound, the same for every checkout); a kernel that refuses a shape (a
parent's narrower probe) is printed "refused", and (k1) K1 alone at the
block-tail shapes of a V=8 convnext_tiny and convnext_large forward (no
post-LN: the route most of a stage's blocks take) beside cuBLAS's two bf16
products on a hidden made beforehand, and the host's time a call (50 calls
enqueued, the device not awaited), with depth-weighted sums, and (swin)
K1 as a Swin MLP half (dw = x, a unit layer scale, eps 1e-5 where the
checkout's K1 takes an eps) at the four (R, C) of a V=8 swin_large ED
call, beside the plain bf16 half the port runs without K1 (two-pass
LayerNorm, F.linear, GELU, F.linear, the residual add) and cuBLAS's two
products, with depth-weighted sums (2, 2, 18, 2). --only picks groups of
those. With --ptxas, the build's ptxas register and spill lines of K1, K4,
K5, K6, M2 (the block-tail kernels), K7, K2, M1 and M3, anonymous-namespace
hashes taken out, for a diff between two checkouts.
Run it by path, not with -m: it chooses which package to import.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

CALLS = ((240, 224), (120, 224), (120, 112))   # ED, VAE x, VAE x_hat: images, px
DIMS = (96, 192, 384, 768)
DEPTHS = (3, 3, 9, 3)
LATENT = (25088, 12544)
SWIN = ("swin_tiny_patch4_window7_224", "swin_large_patch4_window7_224")
SWIN_N = 120     # the V=8 batch of face crops
GROUPS = ("k1k4", "k5k6", "k3", "k7", "k2", "m1m2", "m3", "k1", "swin")
# Swin-L's MLP halves at the ED call's rows (240 images): (R, C, blocks)
SWIN_L_MLP = ((240 * 56 * 56, 192, 2), (240 * 28 * 28, 384, 2), (240 * 14 * 14, 768, 18),
              (240 * 7 * 7, 1536, 2))
# K1 alone: (backbone, stage widths, depths)
K1_BACKBONES = (("tiny", DIMS, DEPTHS), ("large", (192, 384, 768, 1536), (3, 3, 27, 3)))
# past convnext_tiny's widths, at the ED call's rows: (backbone, stage, C)
WIDE = (("large", 0, 192), ("large", 1, 384), ("large", 2, 768), ("large", 3, 1536),
        ("base", 3, 1024))
# M3: the JAX tool's default, then the widest LN-folded shapes of
# convnext_large (stages 2 and 3) and convnext_base (stage 3) at the ED
# call's rows: (name, n, H, C)
M3_EXTRA = (("tool", 240, 56, 96), ("large s2", 240, 14, 768), ("large s3", 240, 7, 1536),
            ("base s3", 240, 7, 1024))


def ptxas_lines(log: str) -> list:
    """(entry, registers/spill line) of the block-tail kernels, hashes out."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f_]+", "", m.group(1))
            entry = name if re.search(
                r"fused_block|fused_stage|fused_wgmma|block_parts|ln_mlp_residual|window_attn|"
                r"layer_norm_rows|dots_kernel|dw_moments", name) else None
        elif entry and ("registers" in line or "spill" in line):
            # the advisory lines name a PTX line, which moves with any edit,
            # and a function with its namespace hash
            text = re.sub(r"_GLOBAL__N__[0-9a-f_]+", "", line.split("info    :")[-1].strip())
            out.append((entry, re.sub(r"line \d+", "line _", text)))
    return out


def block_pack(c: int, dev, g):
    """A block's pack made by the checkout's own pack_block from random
    weights (the timm init's scales, layer scale U(0.1, 1), non-zero
    biases)."""
    import torch

    from genconvit_tpu_torch.ops.cuda import convnext_block as k5

    def r(*shape, s=1.0):
        return s * torch.randn(*shape, device=dev, generator=g)
    return k5.pack_block(r(c, 1, 7, 7, s=0.02), r(c, s=0.1), 1 + r(c, s=0.1), r(c, s=0.1),
                         r(4 * c, c, s=0.02), r(4 * c, s=0.05), r(c, 4 * c, s=0.02),
                         r(c, s=0.05), 0.1 + 0.9 * torch.rand(c, device=dev, generator=g),
                         torch.bfloat16)


def fused_ab(tag: str, dev, g, cuda_ms) -> None:
    """K5 at its shapes (blocks at H >= 28, H % 14 == 0) and K6 at its chains
    (stages at H >= 7, C % 128 == 0) of a V=8 forward, on block_pack's."""
    import torch

    from genconvit_tpu_torch.ops.cuda import convnext_block as k5
    from genconvit_tpu_torch.ops.cuda import convnext_stage as k6

    def pack(c):
        return block_pack(c, dev, g)

    total = {"K5": 0.0, "K6": 0.0}
    for n, px in CALLS:
        for si, c in enumerate(DIMS):
            h = (px // 4) >> si
            x = torch.randn(n, h, h, c, device=dev, generator=g).to(torch.bfloat16)
            if h >= 28 and h % 14 == 0:
                p = pack(c)
                t = cuda_ms(lambda: k5.fused_convnext_block(x, p), 10)
                total["K5"] += DEPTHS[si] * t
                print(f"[{tag}] K5 N={n} H={h} C={c}: {t:.4f} ms (x{DEPTHS[si]})", flush=True)
            if h >= 7 and c % 128 == 0:
                p = k5.stack_blocks([pack(c) for _ in range(DEPTHS[si])])
                t = cuda_ms(lambda: k6.fused_convnext_stage(x, p), 5)
                total["K6"] += t
                print(f"[{tag}] K6 N={n} H={h} C={c} blocks={DEPTHS[si]}: {t:.4f} ms", flush=True)
    for name, t in total.items():
        print(f"[{tag}] {name} per V=8 forward: {t:.4f} ms", flush=True)


def probes_ab(tag: str, dev, g, cuda_ms) -> None:
    """M1 in both modes at K4's 12 shapes (hid = 4C, the tool's operands)
    and at WIDE, M2 at its 7 phases beside K5 on the same block_pack at
    K5's 5 shapes; per forward: x depth. A shape the checkout's probe
    refuses is printed "refused"."""
    import torch

    from genconvit_tpu_torch.ops.cuda import block_parts as m2
    from genconvit_tpu_torch.ops.cuda import convnext_block as k5
    from genconvit_tpu_torch.ops.cuda import int8_dot as m1
    from genconvit_tpu_torch.tools.microbench_int8_dot import make_inputs

    def timed(fn, iters):
        try:
            return cuda_ms(fn, iters)
        except ValueError:
            return None

    shapes = [(n * ((px // 4) >> si) ** 2, c, DEPTHS[si]) for n, px in CALLS
              for si, c in enumerate(DIMS)]
    shapes += [(CALLS[0][0] * ((CALLS[0][1] // 4) >> si) ** 2, c, 0) for _, si, c in WIDE]
    total = {"bf16": 0.0, "int8": 0.0}
    for rows, c, depth in shapes:
        line = []
        for kind, fn in (("bf16", m1.dots_bf16), ("int8", m1.dots_int8)):
            ops = make_inputs(kind, rows, c, 4 * c, dev, g)
            t = timed(lambda: fn(*ops), 10)
            line.append(f"M1 {kind} " + ("refused" if t is None else f"{t:.4f} ms"))
            total[kind] += depth * (t or 0.0)
            del ops
        print(f"[{tag}] R={rows} C={c} hid={4 * c} (x{depth}): " + ", ".join(line), flush=True)
    for kind, t in total.items():
        print(f"[{tag}] M1 {kind} per V=8 forward at K4's shapes: {t:.4f} ms", flush=True)
    ptotal = dict.fromkeys(m2.PHASES + ("K5",), 0.0)
    for n, px in CALLS:
        for si, c in enumerate(DIMS):
            h = (px // 4) >> si
            if not (h >= 28 and h % 14 == 0):
                continue
            p = block_pack(c, dev, g)
            x = torch.randn(n, h, h, c, device=dev, generator=g).to(torch.bfloat16)
            times = {ph: cuda_ms(lambda: m2.block_parts(x, p, ph), 10) for ph in m2.PHASES}
            times["K5"] = cuda_ms(lambda: k5.fused_convnext_block(x, p), 10)
            for name, t in times.items():
                ptotal[name] += DEPTHS[si] * t
            print(f"[{tag}] M2 N={n} H={h} C={c} (x{DEPTHS[si]}): " + ", ".join(
                f"{name} {t:.4f}" for name, t in times.items()) + " ms", flush=True)
    prev, line = 0.0, []
    for name in m2.PHASES:
        line.append(f"{name} {ptotal[name]:.4f}"
                    + ("" if name == "dw_bf16acc" else f" (+{ptotal[name] - prev:.4f})"))
        prev = prev if name == "dw_bf16acc" else ptotal[name]
    print(f"[{tag}] M2 per V=8 forward at K5's shapes (15 launches a phase): "
          + ", ".join(line) + f" ms; K5 {ptotal['K5']:.4f} ms", flush=True)


def m3_bound(n: int, h: int, w: int, c: int) -> tuple:
    """M3's bound, (ms, 'bytes' or 'operations'), whatever the checkout's
    tool says: x in and dw out (bf16), mean and var out (f32), the weights
    once; 2 f32 operations for each tap whose input lies inside the image."""
    from genconvit_tpu_torch.tools._timing import FP32, bound_ms

    def taps(length):
        return sum(min(p, 3) + min(length - 1 - p, 3) + 1 for p in range(length))
    px = n * h * w
    return bound_ms(px * c * 4 + px * 8 + 200 * c, {FP32: 2 * n * c * taps(h) * taps(w)})


def kernel_device_ms(fn, iters: int, name: str) -> float:
    """Device ms per launch of the kernels whose name holds `name` (one a
    call of fn), from torch.profiler over iters calls: the kernel's own
    time, which CUDA events around back-to-back calls read only where it
    exceeds the caller's host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name in e.key]
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in events)
    # per launch of the kernels the trace holds (one a call): a trace that
    # drops launches leaves the mean right
    return us / max(1, sum(e.count for e in events)) / 1e3


def m3_ab(tag: str, dev, g, cuda_ms) -> None:
    """M3 at M3_EXTRA's shapes (x0) and at the LN-folded blocks of a V=8
    forward under pallas='1' (x depth), on the tool's operands: CUDA events
    around back-to-back wrapper calls and the kernel's device time from the
    profiler, beside cuDNN dw + 2 reductions and m3_bound; per forward: x
    depth."""
    import torch

    from genconvit_tpu_torch.ops.cuda import dw_moments as m3
    from genconvit_tpu_torch.tools.microbench_dwshift import make_inputs

    shapes = [M3_EXTRA[0] + (0,)]
    for call, (n, px) in zip(("ED", "VAE x", "x_hat"), CALLS):
        for si, c in enumerate(DIMS):
            h = (px // 4) >> si
            if not (h >= 28 and h % 14 == 0):   # K5's rule leaves the block out
                shapes.append((f"{call} s{si}", n, h, c, DEPTHS[si]))
    shapes += [extra + (0,) for extra in M3_EXTRA[1:]]
    total = {"kernel": 0.0, "device": 0.0, "library": 0.0, "bound": 0.0}
    for name, n, h, c, depth in shapes:
        x, k, b = make_inputs(n, h, c, dev, g)
        iters = max(10, min(200, int(2e8 // (n * h * h * c))))
        try:
            t = cuda_ms(lambda: m3.dw_moments(x, k, b), iters)
            t_d = kernel_device_ms(lambda: m3.dw_moments(x, k, b), iters, "dw_moments")
        except ValueError:
            t = t_d = None
        t_l = cuda_ms(lambda: m3.dw_moments_library(x, k, b), iters)
        bd, side = m3_bound(n, h, h, c)
        total["kernel"] += depth * (t or 0.0)
        total["device"] += depth * (t_d or 0.0)
        total["library"] += depth * t_l
        total["bound"] += depth * bd
        shown = "refused" if t is None else f"{t:.4f} ms (device {t_d:.4f})"
        print(f"[{tag}] M3 {name} N={n} H={h} C={c} (x{depth}): {shown}, library "
              f"{t_l:.4f} ms, bound {bd:.4f} ms ({side})", flush=True)
        del x, k, b
    print(f"[{tag}] M3 per V=8 forward at the LN-folded blocks (39 launches): kernel "
          f"{total['kernel']:.4f} ms (device {total['device']:.4f}), library "
          f"{total['library']:.4f} ms, bound {total['bound']:.4f} ms", flush=True)


def k7_ab(tag: str, dev, g, cuda_ms) -> None:
    """K7 at each stage of swin_tiny and swin_large at N = 120 (224 px),
    masked (the shifted blocks) and unmasked, on random qkv and an O(1) bias
    gathered as the model gathers it; per forward: x the blocks of each."""
    import numpy as np
    import torch

    from genconvit_tpu_torch.models.swin import (SWIN_CFGS, block_window,
                                                 relative_position_index, shifted_window_mask)
    from genconvit_tpu_torch.ops.cuda import window_attn as k7

    for name in SWIN:
        cfg = SWIN_CFGS[name]
        hw, dim, total = 224 // 4, cfg["embed_dim"], 0.0
        for si, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
            geo = [block_window((hw, hw), cfg["window"], bi) for bi in range(depth)]
            w, n_masked = geo[0][0], sum(shift > 0 for _, shift in geo)
            nw, l, hd = (hw // w) ** 2, w * w, dim // heads
            b = SWIN_N * nw
            qkv = torch.randn(b, l, 3 * dim, device=dev, generator=g).to(torch.bfloat16)
            table = torch.randn((2 * w - 1) ** 2, heads, device=dev, generator=g)
            idx = torch.from_numpy(relative_position_index(w).reshape(-1).astype(np.int64))
            bias = table[idx.to(dev)].view(l, l, heads).permute(2, 0, 1).contiguous()
            mask = torch.from_numpy(shifted_window_mask(hw, hw, w, w // 2)).to(dev)
            for m, count in ((mask, n_masked), (None, depth - n_masked)):
                if count:
                    wpm = nw if m is not None else 1
                    t = cuda_ms(lambda: k7.window_attention(qkv, bias, m, heads, wpm), 20)
                    total += count * t
                    print(f"[{tag}] K7 {name.split('_')[1]} s{si} B={b} heads={heads} L={l} "
                          f"mask={int(m is not None)}: {t:.4f} ms (x{count})", flush=True)
            del qkv
            hw, dim = hw // 2, dim * 2
        print(f"[{tag}] K7 per {name.split('_')[1]} forward at N={SWIN_N}: {total:.4f} ms",
              flush=True)


def k2_ab(tag: str, dev, g, cuda_ms) -> None:
    """K2 at the stem LN of each backbone call of a V=8 forward, at
    convnext_tiny's C = 96 and convnext_large's C = 192; per forward: the
    three calls' sum."""
    import torch

    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km

    for c, name in ((DIMS[0], "convnext_tiny"), (192, "convnext_large")):
        total = 0.0
        s = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).float()
        b = (0.1 * torch.randn(c, device=dev, generator=g)).float()
        for n, px in CALLS:
            rows = n * (px // 4) ** 2
            x = (3 * torch.randn(rows, c, device=dev, generator=g) + 0.5).to(torch.bfloat16)
            t = cuda_ms(lambda: km.layer_norm_rows(x, s, b), 20)
            total += t
            print(f"[{tag}] K2 {name} R={rows} C={c}: {t:.4f} ms", flush=True)
            del x
        print(f"[{tag}] K2 {name} per V=8 forward (3 launches): {total:.4f} ms", flush=True)


def mlp_ab(tag: str, dev, g, cuda_ms) -> None:
    """K1 and K4 in both modes at the 12 block-tail shapes of a V=8 forward,
    on folds of random weights at the init's scales; per forward: x depth."""
    import torch

    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
    from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4

    total = dict.fromkeys(("K1",) + tuple(f"K4 {m}" for m in k4.MODES), 0.0)
    for n, px in CALLS:
        for si, c in enumerate(DIMS):
            rows = n * ((px // 4) >> si) ** 2

            def r(*shape, s=1.0):
                return s * torch.randn(*shape, device=dev, generator=g)
            args = (1 + r(c, s=0.1), r(c, s=0.1), r(4 * c, c, s=c ** -0.5), r(4 * c, s=0.05),
                    r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.05),
                    0.1 + 0.9 * torch.rand(c, device=dev, generator=g))
            dw = (2 * r(rows, c)).to(torch.bfloat16)
            x = r(rows, c).to(torch.bfloat16)
            folds = {"K1": (km.ln_mlp_residual, km.fold_block_mlp(*args, torch.bfloat16))}
            for m in k4.MODES:
                folds[f"K4 {m}"] = (k4.ln_mlp_residual_int8,
                                    k4.fold_block_mlp_int8(*args, m, torch.bfloat16))
            line = []
            for name, (fn, folded) in folds.items():
                t = cuda_ms(lambda: fn(dw, x, folded), 10)
                total[name] += DEPTHS[si] * t
                line.append(f"{name} {t:.4f} ms")
            print(f"[{tag}] R={rows} C={c}: " + ", ".join(line), flush=True)
            del folds, dw, x
    for name, t in total.items():
        print(f"[{tag}] {name} per V=8 forward (depth-weighted): {t:.4f} ms", flush=True)


def k1_ab(tag: str, dev, g, cuda_ms) -> None:
    """K1 at the 12 block-tail shapes of a V=8 forward of each backbone in
    K1_BACKBONES, beside cuBLAS's two bf16 products; per forward: x depth."""
    import torch

    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km

    for name, dims, depths in K1_BACKBONES:
        k1_total = products_total = host_total = 0.0
        for n, px in CALLS:
            for si, c in enumerate(dims):
                rows = n * ((px // 4) >> si) ** 2

                def r(*shape, s=1.0):
                    return s * torch.randn(*shape, device=dev, generator=g)
                folded = km.fold_block_mlp(
                    1 + r(c, s=0.1), r(c, s=0.1), r(4 * c, c, s=c ** -0.5), r(4 * c, s=0.05),
                    r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.05),
                    0.1 + 0.9 * torch.rand(c, device=dev, generator=g), torch.bfloat16)
                dw = (2 * r(rows, c)).to(torch.bfloat16)
                x = r(rows, c).to(torch.bfloat16)
                t = cuda_ms(lambda: km.ln_mlp_residual(dw, x, folded), 10)
                # the host's time a call: 50 calls enqueued, the device not awaited
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    km.ln_mlp_residual(dw, x, folded)
                host_us = (time.perf_counter() - t0) / 50 * 1e6
                torch.cuda.synchronize()
                del dw, x
                y = r(rows, c).to(torch.bfloat16)
                h = r(rows, 4 * c).to(torch.bfloat16)
                t_p = cuda_ms(lambda: (torch.matmul(y, folded.wg), torch.matmul(h, folded.w2g)), 10)
                del y, h
                k1_total += depths[si] * t
                products_total += depths[si] * t_p
                host_total += depths[si] * host_us / 1e3
                print(f"[{tag}] K1 {name} R={rows} C={c}: {t:.4f} ms, two products {t_p:.4f} ms, "
                      f"host {host_us:.1f} us a call", flush=True)
        print(f"[{tag}] K1 {name} per V=8 forward (depth-weighted): {k1_total:.4f} ms, "
              f"two products {products_total:.4f} ms, host {host_total:.4f} ms", flush=True)


def swin_ab(tag: str, dev, g, cuda_ms) -> None:
    """K1 as Swin-L's MLP half (SWIN_L_MLP) beside the plain bf16 half and
    cuBLAS's two products; per forward: x blocks."""
    import inspect

    import torch
    import torch.nn.functional as F

    from genconvit_tpu_torch.ops.act import gelu
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
    from genconvit_tpu_torch.ops.norm import layer_norm

    eps = {"eps": 1e-5} if "eps" in inspect.signature(km.ln_mlp_residual).parameters else {}
    tot = [0.0, 0.0, 0.0]
    for rows, c, blocks in SWIN_L_MLP:
        def r(*shape, s=1.0):
            return s * torch.randn(*shape, device=dev, generator=g)
        lw, lb = 1 + r(c, s=0.1), r(c, s=0.1)
        w1, b1 = r(4 * c, c, s=c ** -0.5), r(4 * c, s=0.05)
        w2, b2 = r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.05)
        folded = km.fold_block_mlp(lw, lb, w1, b1, w2, b2, torch.ones(c, device=dev),
                                   torch.bfloat16)
        lw, lb, w1, b1, w2, b2 = (t.to(torch.bfloat16) for t in (lw, lb, w1, b1, w2, b2))
        x = r(rows, c).to(torch.bfloat16)

        def plain():
            z = gelu(F.linear(layer_norm(x, lw, lb, 1e-5), w1, b1))
            return x + F.linear(z, w2, b2)
        t = cuda_ms(lambda: km.ln_mlp_residual(x, x, folded, None, "default", **eps), 10)
        t_half = cuda_ms(plain, 10)
        del x
        y = r(rows, c).to(torch.bfloat16)
        h = r(rows, 4 * c).to(torch.bfloat16)
        t_p = cuda_ms(lambda: (torch.matmul(y, folded.wg), torch.matmul(h, folded.w2g)), 10)
        del y, h
        for i, v in enumerate((t, t_half, t_p)):
            tot[i] += blocks * v
        print(f"[{tag}] K1 swin_large MLP half R={rows} C={c}: {t:.4f} ms, plain bf16 half "
              f"{t_half:.4f} ms, two products {t_p:.4f} ms", flush=True)
    print(f"[{tag}] K1 swin_large MLP halves per V=8 forward (24 blocks): {tot[0]:.4f} ms, "
          f"plain bf16 halves {tot[1]:.4f} ms, two products {tot[2]:.4f} ms", flush=True)


def k3_ab(tag: str, dev, g, cuda_ms) -> None:
    """K3 on the latent head at M = 15, 30, 120 beside F.linear on the bf16
    head."""
    import torch
    import torch.nn.functional as F

    from genconvit_tpu_torch.ops.cuda import int8_matmul as k3
    from genconvit_tpu_torch.ops.quant import quantize_wint8

    k, n = LATENT
    w16 = (0.01 * torch.randn(n, k, device=dev, generator=g)).to(torch.bfloat16)
    wq, sc = quantize_wint8(w16, dim=1)
    b = 0.1 * torch.randn(n, device=dev, generator=g)
    b16 = b.to(torch.bfloat16)
    for m in (15, 30, 120):
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        t = cuda_ms(lambda: k3.matmul_wint8(x, wq, sc, b), 20)
        t_l = cuda_ms(lambda: F.linear(x, w16, b16), 20)
        print(f"[{tag}] K3 M={m}: {t:.4f} ms, F.linear on the bf16 head {t_l:.4f} ms",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-dir", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups to time: " + ", ".join(GROUPS))
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"--only: unknown groups {sorted(only - set(GROUPS))}")
    pkg_dir = os.path.abspath(args.package_dir)
    sys.path.insert(0, pkg_dir)
    import torch

    import genconvit_tpu_torch
    from genconvit_tpu_torch.ops.cuda import _build

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    tag = os.path.relpath(os.path.dirname(os.path.dirname(genconvit_tpu_torch.__file__)))
    dev = torch.device("cuda", 0)
    info = _build.build()
    print(f"[{tag}] build {info.seconds:.1f} s, {torch.cuda.get_device_name(0)}", flush=True)
    if args.ptxas:
        for entry, line in ptxas_lines(info.log):
            print(f"[{tag}] ptxas {entry}: {line}")

    def cuda_ms(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    g = torch.Generator(device=dev).manual_seed(3)
    for group, fn in (("k1k4", mlp_ab), ("k5k6", fused_ab), ("k3", k3_ab), ("k7", k7_ab),
                      ("k2", k2_ab), ("m1m2", probes_ab), ("m3", m3_ab), ("k1", k1_ab),
                      ("swin", swin_ab)):
        if group in only:
            fn(tag, dev, g, cuda_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
