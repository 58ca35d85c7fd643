#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (genconvit_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):

  1. card identity: nvidia-smi's name and power limit;
  2. build: nvcc compiles csrc/ into build/ (first use only), with
     ptxas's register and spill report;
  3. kernels vs their plain PyTorch versions in bf16, at every shape the
     scoring path gives them (K1 and K4 in both int8 modes at the 12
     backbone-call x stage shapes, with the post-LN variant at stages 0-2,
     and with x = 0, where the output is the MLP branch alone; K1 and K4
     also at the widths past convnext_tiny's: convnext_large's 192, 384, 768
     and 1536 and convnext_base's 1024, at the ED call's rows; K2 at the three
     stem LNs and at each of its instantiations (its own at C = 96, 128 and
     192, the generic one at 64, 320 and 1056) on 1013 rows; K3 at M = 1,
     15, 30, 120 and 240 on the 25088x12544 head and
     at one odd shape); pass: max|diff| / max|ref| <= 3e-2 and every element
     within 2 bf16 ulps (3 for K4: one int8 step, see convnext_mlp_int8),
     since both versions round at the same points; planted faults (K1:
     fc2 bias, LN-bias fold, layer scale dropped; K2: bias dropped; K3:
     bias dropped, scale replaced by its mean; K4: b2g dropped, LN-bias
     fold dropped, s1 replaced by its mean) must fail that check; K2's and
     K7's plans (k2_plan, k7_plan) against the library's; CUDA-
     event times of kernel and plain version, of the plain bf16 graph (K1),
     of K1 at K4's shapes, and of the one PyTorch call that computes the
     same function where there is one (F.layer_norm for K2, F.linear on
     the bf16 head for K3, cuBLAS's two bf16 products at hid = 4C for K1,
     torch._int_mm then torch._int_mm ('full') or a bf16 torch.matmul
     ('fc1') for K4),
     beside the bound at the H100's published peaks; K1's tile plan as the
     library computes it against its Python mirror, at every width, and
     K4's in both modes;
     K5 at its five path shapes and K6 at its five chains (pallas '1' and
     'stage'), held the same way, K6 block by block (the chain cut after
     block k against the plain block k on the kernel's own input, each
     within 2 ulps), with planted faults (dw bias dropped, dw kernel
     transposed, LN bias dropped, layer scale 1; for K6 also the LN bias
     dropped in the middle block alone, the middle block skipped and the
     blocks reversed), timed beside their plain versions, the cuDNN
     depthwise conv + K1 at the same shapes (the default path for those
     blocks) and the bound, which lets the tensor cores and the f32 cores
     run at the same time; K6 also at convnext_large's three K6 widths (384,
     768, 1536) and convnext_base's 1024 at the ED call's rows, chains cut
     to 3 blocks, held, faulted and timed the same way; K5's and K6's plans
     (k5_plan, k6_plan) against the library's at every shape; K7 (Swin window attention) at the four stage
     shapes of swin_tiny and of swin_large at N = 120 (masked at stages 0-2,
     unmasked at all four) and at head widths 16 and 64 and windows of 16
     tokens on 2 nW + 5 windows (ragged against the persistent grid),
     within 2 bf16 ulps of the window-head's largest |out|
     (window_attn.ulp_error), with planted faults (relative bias dropped,
     bias taken window-fastest, bias of the neighbouring head group, ring
     off by one stage, the last query strip's valid rows dropped, mask
     dropped, mask of the window before, hd^-1/2 scale omitted), timed
     beside its plain version, the one SDPA call with bias + mask as a
     float attn_mask, and the bound;
  4. the scoring path through the Predictor: net='genconvit',
     convnext_tiny, 224 px, 15 frames, random weights on the device from a
     seed, the real 25088x12544 VAE heads; V=1, V=2 with masked frames,
     V=8, predict_faces with k<F faces and with none; in six
     configurations: the default (every forward launches K1 54 times and
     K2 3 times), int8 heads (K3 once more), int8_mlp='fc1' and int8 heads
     + int8_mlp='full' (K4 54 times in place of K1), pallas='1' (K5 15
     times, nothing else) and pallas='stage' (K6 5 times, one per chain,
     nothing else); peak device memory;
  5. each configuration vs the port's float32 plain path on the same
     weights (layer scale randomized, both heads' last layer scaled so
     that verdicts are decisive, deterministic VAE, TF32 off for the
     float32 pass): max|dy_val| <= 2e-2 (4e-2 with int8 tails), equal y
     wherever the float32 class means differ by more than twice that;
  6. throughput, each configuration: videos/s and ms/launch at V=8 and
     V=1 on device-resident distinct inputs in rotating buffers, one sync
     per trial, and the V=1 latency of a synchronized call;
  7. only with --profile: torch.profiler over 3 V=8 forwards of the
     default, the int8 heads + 'full', the pallas='1' and the
     pallas='stage' configuration, and over 3 N=120 swin_tiny forwards with
     K7, device time by kernel group and the device's busy share of the
     wall time;
  8. the Swin slice: swin_tiny at full width and depth, 224 px, random
     weights from a seed with O(1) bias tables, through
     SwinTransformer.features and forward and HybridEmbed.tokens
     (feature_dim 768) at N = 120 and 15 (the V=8 and V=1 batches of face
     crops), in bf16 with K7 (12 launches per forward, 5 with a mask) and
     with pallas='0' (none); each against the float32 plain path on the
     same weights (TF32 off) and K7 against pallas='0', max|diff| /
     max|ref| <= 3e-2; images/s and ms per forward of both plans at both
     N, peak device memory;
  9. the probes M1-M3 (ops/cuda int8_dot, block_parts, dw_moments; the
     port's microbenchmark tools, which no model path runs), each against
     its plain version: M1 in both variants at the JAX tool's default shape,
     at K4's 12 block-tail shapes (hid = 4C) and at convnext_large's four
     stage widths and convnext_base's 1024 at the ED call's rows, M2 at its 7
     phases at K5's 5 path shapes and at C = 1024 and 1536 (240 x 7^2), M3
     at the JAX tool's default shape, at the 7 shapes of the LN-folded
     blocks under pallas='1' and at convnext_large's and convnext_base's
     widest ones at the ED call's rows (M3_WIDE), two launches giving the
     same bits; pass: max|diff| / max|ref|
     <= 3e-2 and every element within 2 bf16 ulps (M1 int8: 1 ulp of the
     exact integer sums; M3's mean and var within dw_moments.MOMENT_TOL of
     their scales); planted faults (M1: z's add dropped, s1 by its mean, w2
     transposed; M2 from 'dw' on: dw bias dropped, dw kernel transposed,
     from 'ln' on: LN bias dropped; M3: bias dropped, kernel transposed, var
     without - mean^2, the halo rows from the image before, the last
     channel slice out of the moments) must fail; CUDA-event times of kernel, plain version
     and library yardstick (M1: two torch.matmul or torch._int_mm calls and
     the epilogue; M2 'dw': cuDNN's depthwise conv, 'full': cuDNN's
     depthwise conv + K1; M3: cuDNN's depthwise conv + the two reductions)
     beside the bound and the term that sets it; M2's per-phase deltas;
     M3's gap between the moments of the f32 sums and of the rounded dw;
     the HGMMA/IGMMA/HMMA/IMMA counts of each M1 instantiation's SASS
     (warpgroup MMA alone, its three loops there). Then the three tools' main() at
     their default shapes with every count at 0 before: the M kernels'
     launches in the kernels' record come from that run.

  10. convnext_large (the JAX package's `--s large` backbone: dims
     192/384/768/1536, depths 3/3/27/3) at full width and depth, 224 px,
     random weights from a seed, through the default plan, through int8
     heads + int8_mlp='full' and through pallas='stage': the requests of
     phase 4 with 108 K1 (or K4) and 3 K2 launches per forward (and K3's
     one), or 8 K6 launches (ED and VAE x at stages 1-3, x_hat at stages
     1-2), throughput as in phase 6 (with --profile, the default plan's
     breakdown too), and parity against its float32 plain path as in phase
     5 (max|dy_val| <= 2e-2, 4e-2 with the int8 tails). It runs after
     phase 5.

  11. the video-to-verdict path (it runs after phase 9): (a) seeded random
     ED and VAE weights at full size (convnext_tiny, 224 px, the real 25088x12544
     heads, layer scale and heads' last layer as in phase 5) written by the
     port's writers, the ED as a `.gcv` nested under 'ed', the VAE as a
     reference-keyed `.pth` with the dead groups added and as a `.gcv`
     whose two latent-head kernels take flax's chunked form (> 2^30 bytes),
     each read back by `load_params` equal to the written tensors, and
     `Predictor(ed_weight=.gcv, vae_weight=.pth)` holding them cast to bf16
     bit for bit; file sizes and seconds; (b) the committed face detector
     on the card against the same module on the CPU, with PyTorch's flags
     as a user has them (the detector's forward turns cuDNN's TF32 off for
     itself and puts the flag back), on 512 seeded windows: logits and
     boxes within 1e-3, post-NMS slots equal wherever the score lies more
     than 1e-2 from 0.3 (a slot may pick another anchor only on a score
     tie), the planted faults (anchor offsets unscaled; the forward left in
     TF32) refused; and `detect_many` as `predict_files` runs it, card against
     CPU over the corpus of (d): the same box count in every frame, corners
     within 2 px; (c) crop_faces on the card against the CPU
     on 1080x1920 frames with boxes that up- and downscale, one axis of
     each, and touch the edges: at most 1 LSB, the planted fault (cv2's
     coupled fallback dropped) refused; (d) predict_files over eight
     synthetic videos of 15 frames with drawn faces (1920x1080, 1280x720,
     640x360, 256x256, two each), a zero-face one and one whose decode
     raises, with the device detector ('jax'), recorded boxes (a sidecar
     with up to two boxes a frame, quirk B7) and 'center': None for the
     failed decode, the default verdict for zero faces (recorded), each
     recorded video's crops and mask in exactly one launch row whose
     verdict is the one returned for it, bit for bit, and that verdict
     within 2e-3 of predict_faces on the same crops, the planted assembly
     faults (two videos' faces swapped in a launch, a mask one frame off)
     refused; exactly 54 K1 + 3 K2 launches per forward; the frames in
     which the detector fired, printed; (e) the CLI (`genconvit_tpu_torch
     .prediction.main`) in-process over placeholder files with
     `--face-backend recorded`, weights resolved by name (the ED and the
     chunked VAE `.gcv`): every video in the result JSON with the JAX
     package's keys; (f) predict_files with the device detector at
     video_batch=8 over 64 videos (the eight, eight times: 8 groups, so
     that decode, detect and forward of successive groups overlap), three
     runs: videos/s median, min and max, the median run's StageTimers, peak
     device memory; then one group's detect step by step. So that the
     phase runs without cv2 or FFmpeg, the decode of the file paths,
     `engine.extract_frames`, is substituted for the
     whole phase by an in-memory source of the seeded frames.

  12. the serving path and the remaining entry points (it runs after phase
     11, on its weights, read by name from the same directory, and its
     corpus; convnext_tiny, 224 px, full width and depth, the default plan,
     deterministic VAE; `engine.extract_frames` substituted for the whole
     phase by the corpus in memory, each request body and placeholder file
     holding the name of the video it stands for): (a) `serve.make_handler`
     under ThreadingHTTPServer on 127.0.0.1:0 in each mode, 'staged'
     (StagedPipeline, greedy drain), 'micro' (MicroBatcher, 8 ms window) and
     'none' (the lock): 64 POSTs (the eight face videos eight times under
     aliased names) at concurrency 8, each 200 response's pred within 2e-3
     of `predict_video` on the same video and its y the same where that
     verdict is decisive; the zero-face video (0, 0.5) with faces_found 0,
     the failed decode a 500 naming it, an empty body 400, a garbage body
     500, an unknown path 404, /healthz 200; /statz in 'staged' and 'micro':
     videos_scored 64, device_launches below that, one launch of two videos
     or more; in every mode exactly 54 K1 + 3 K2 launches per forward,
     counted from 0 before the 64 requests; requests/s, p50 and p95 latency,
     launches and videos per launch; the planted fault (a staged pipeline
     that hands each drain's results out in reverse order) refused; (b)
     `predict_videos_stream` over four [8,15,224,224,3] batches equals
     `predict_videos_batched` on each, bit for bit, timed against the four
     calls one after the other; (c) `prediction_v2.main` in-process over
     placeholder files named with and without "fake", recorded boxes: the
     JAX package's result keys, the metrics block (no sklearn loaded), and
     the verdicts of the `prediction` CLI on the same files; (d) evaluate's
     `score_batches` over 64 seeded 224 px face images of an ImageFolder of
     placeholders (`folder.load_image` substituted) at batch 32: P(class 1)
     within 2e-2 of the port's float32 plain path (TF32 off), the report
     printed; peak device memory.

  13. training (it runs last; `--train-only` runs phases 1, 2 and 13 alone):
     convnext_tiny GenConViT at full width and depth, 224 px, random weights
     from a seed (layer scale U(0.1, 1)), float32 masters, one seeded uint8
     batch and eps; TF32 off. (a) one step from the same weights in float32
     (batch 32 and 8; the references) and under bf16 in the default plan (K1,
     K2; batch 32), pallas '0' (no kernels; batch 32 and 8), int8_mlp='fc1'
     (K4), pallas '1' (K5) and pallas 'stage' (K6) (batch 8): the loss, each
     branch's and backbone's gradient and parameter change after Adam
     (relative L2) against the float32 step of the batch, each kernel plan's
     error at most 3x pallas '0''s (floor 1e-3); the VAE's var head moved by
     its decay; BN0's running mean = 0.9 old + 0.1 batch mean; (b) planted
     faults refused: the kernel backbone's folds reused from before a step
     (ED features vs the reference graph, rel L2 limit 3e-2), pallas '1''s
     LN-folded blocks folded without a graph (their norm and fc1 gradient
     vs f32, limit 0.5), missing gradients left None (the var head unmoved),
     BN statistics updated in place under remat (the momentum twice); (c)
     launches a step equal to expected_launches per forward twice over
     (forward and recompute); (d) 8 bf16 steps on one batch (the loss must
     fall), steps/s and images/s at batch 32 in float32 and bf16, median of
     3 runs of 3 steps, peak device memory, the device time of a bf16 step
     in KernelBackbone's backward (CUDA events; with --profile, the
     profiler's breakdown of the step by kernel group); (e) `python -m
     genconvit_tpu_torch.train -m genconvit -e 1 -b 8 --bf16` in-process over
     a generated ImageFolder (placeholders; `folder.load_image` by memory,
     `augment.strong_aug` the identity: no cv2 here), then resumed with -p;
     K1 and K2 launches as its steps and eval forwards; the `.gcv` (epoch,
     Adam count, weights equal to the model's) and `.pkl` read back.

  14. the updated VAE, the SwiGLU heads, dw_rank and the 'mlp' plan values
     (it runs after phase 12 and before phase 13; `--phase14-only` runs
     phases 1, 2 and 14 alone):
     convnext_tiny GenConViT at full width and depth, 224 px, seeded random
     weights (layer scale U(0.1, 1), both heads' last layer scaled, as in
     phase 5), each configuration against the port's float32 plain path on
     the same weights (deterministic VAE, TF32 off): max|dy_val| <= 2e-2 and
     equal y on decisive videos, the launches of one forward equal to the
     count `p14_launches` states, videos/s at V=8 where named. (a) the
     updated VAE (one 2N backbone call: 36 K1 + 2 K2 a forward), default
     plan and int8 heads (K3 once deterministic, twice when it samples:
     mu and var), V=8 videos/s; (b) SwiGLU heads on both branches (54 K1 +
     3 K2); (c) dw_rank: rank 7 against the exact default (<= 2e-2 from it
     and from float32), rank 1 (V=8 videos/s) and 'auto:0.8' run with 54 K1
     and print their retained energy, rank 1 under int8_mlp='fc1' launches
     54 K4, dw_rank with pallas '1' and 'stage' refused; (d) pallas
     'mlp:0,1' (18 K1, no K2), 'mlp' (54, 0) and 'mlpfull' (54, 3), each
     with V=8 videos/s; (e) one bf16 step of the updated VAE ('vae' net,
     default plan: 36 K1 + 2 K2) and of genconvit under 'mlp:0,1' (36 K1)
     against the float32 step of the batch (8), each error at most 3x pallas
     '0''s (floor 1e-3), and after the updated step all 7 BatchNorms'
     running means written back (moved, within 0.25 of the float32 step's
     change).

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
                     # elementwise bound is km.ULP_TOL bf16 ulps (K4: k4.ULP_TOL)
YVAL_TOL = 2e-2      # bf16 kernel path vs float32 plain path
YVAL_TOL_INT8 = 4e-2  # with int8 block tails (onchip_parity.py:77-84's int8 bound)
LOGIT_SCALE = 30.0   # phase 5 scales both heads' last layer by this
HBM = 3.35e12        # H100 SXM published peaks: bytes/s,
BF16 = 989e12        # dense bf16 tensor-core flop/s,
INT8 = 1979e12       # dense int8 tensor-core op/s,
FP32 = 67e12         # f32 flop/s outside the tensor cores
LATENT = (25088, 12544)  # the VAE mu head, K x N
FRAMES = 15
IMG = 224
CALLS = (("ed", 240, 224), ("vae_x", 120, 224), ("vae_xhat", 120, 112))
DIMS = (96, 192, 384, 768)
DEPTHS = (3, 3, 9, 3)
# the slices' configurations: (name, pallas, int8_mlp, int8_heads)
CONFIGS = (("default", "", "", False), ("int8_heads", "", "", True),
           ("int8_mlp=fc1", "", "fc1", False), ("int8_heads+full", "", "full", True),
           ("pallas=1", "1", "", False), ("pallas=stage", "stage", "", False))
PROFILED = ("default", "int8_heads+full", "pallas=1", "pallas=stage")
K5_PER_FORWARD = 15  # blocks with H >= 28, H % 14 == 0: ED 3+3, VAE x 3+3, x_hat 3
K6_PER_FORWARD = 5   # stages with H >= 7, C % 128 == 0: ED s2, s3, VAE x s2, s3, x_hat s2
SWIN_TINY = "swin_tiny_patch4_window7_224"
SWIN_LARGE = "swin_large_patch4_window7_224"
SWIN_BATCHES = (120, 15)   # the V=8 and V=1 batches of 15 face crops
K7_PER_FORWARD = (12, 5)   # swin_tiny at 224 px: launches, of them with a mask
# K1 at the widths the tiny backbone never reaches: convnext_large's four
# stages and convnext_base's last, at their ED-call rows (240 x 56^2 >> 2s)
K1_WIDE = (("large", 0, 192), ("large", 1, 384), ("large", 2, 768), ("large", 3, 1536),
           ("base", 3, 1024))
LARGE = "convnext_large"
LARGE_K1_PER_FORWARD = 108   # 36 blocks x 3 backbone calls (K1, or K4 under int8_mlp)
LARGE_K6_PER_FORWARD = 8     # pallas='stage': ED and VAE x at stages 1-3, x_hat at 1-2
LARGE_CONFIGS = (CONFIGS[0], CONFIGS[3], CONFIGS[5])   # default; int8 heads + 'full'; 'stage'
# K6 at the widths the tiny backbone never reaches, at the ED call's rows:
# convnext_large's three K6 stages and convnext_base's last, (name, stage,
# H, C), each chain cut to 3 blocks (large's stage 2 has 27)
K6_WIDE = (("large", 1, 28, 384), ("large", 2, 14, 768), ("large", 3, 7, 1536),
           ("base", 3, 7, 1024))
K6_WIDE_BLOCKS = 3
K2_CHECK_WIDTHS = (96, 128, 192, 64, 320, 1056)   # K2's own instantiations, then generic
K2_CHECK_ROWS = 1013   # ragged against every instantiation's rows per block
# K7 beyond the Swin stage shapes: (L, heads, hd, windows per mask), B = 2 nW + 5
K7_EXTRA = ((49, 4, 16, 4), (49, 3, 64, 4), (16, 3, 16, 1), (16, 3, 64, 16))
# M2 past convnext_tiny's widths: (call, n, H, C, blocks per forward)
M2_WIDE = (("base ed", 240, 7, 1024, 0), ("large ed", 240, 7, 1536, 0))
M1_TOOL_SHAPE = (240, 56, 128)   # the JAX tools' default n, h, c: M1 (hid 3c) ...
M3_TOOL_SHAPE = (240, 56, 96)    # ... and M3 (C unpadded)
# M3 past convnext_tiny's widths: the widest LN-folded shapes of
# convnext_large (stages 2, 3) and convnext_base (stage 3) at the ED call's
# rows, (call, n, H, C, blocks per forward)
M3_WIDE = (("large s2", 240, 14, 768, 0), ("large s3", 240, 7, 1536, 0),
           ("base s3", 240, 7, 1024, 0))


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


def compare(torch, km, what: str, out, ref, x=None, scale=None, tol=None) -> tuple:
    """Kernel output vs its plain version: finite, max|diff| / max|ref| <=
    REL_TOL, and every element within tol (default km.ULP_TOL) bf16 ulps
    (km.bf16_ulp_error with the residual input x and the scale floor)."""
    tol = km.ULP_TOL if tol is None else tol
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    ulps = km.bf16_ulp_error(out, ref, x, scale)
    if not (torch.isfinite(out).all() and rel <= REL_TOL and ulps <= tol):
        raise AssertionError(f"{what}: max|diff| {err:.3e}, /max|ref| {rel:.3e} "
                             f"(limit {REL_TOL}), {ulps} bf16 ulps (limit {tol})")
    return err, rel, ulps


def must_fail(torch, km, what: str, out, ref, x=None, scale=None, tol=None) -> str:
    """A planted fault: the check must refuse it."""
    tol = km.ULP_TOL if tol is None else tol
    torch.cuda.synchronize()
    rel = (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
    ulps = km.bf16_ulp_error(out, ref, x, scale)
    if ulps <= tol:
        raise AssertionError(f"planted fault {what} passed the check ({ulps} ulps)")
    return f"{what}: {ulps:.1f} ulps, rel {rel:.2e} -> refused"


def bound(nbytes: float, *units: dict) -> tuple:
    """The least time the card could take, in ms, and what sets it: the
    bytes over the HBM rate, or the busiest unit's operations, whichever is
    larger. Each unit ({peak: count}) is one kind of pipe (the tensor cores,
    the f32 cores): the types it runs share its time and add up, while
    different units run at the same time."""
    t_bytes = nbytes / HBM
    t_ops = max(sum(n / peak for peak, n in ops.items()) for ops in units)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mlp_bound(rows: int, c: int, mode: str, post: bool = False) -> tuple:
    """Bound of one block-tail launch: d, x and out once (bf16), the folded
    weights once; 16*R*C^2 operations of the two matmuls, on the bf16 or
    the int8 tensor cores by mode."""
    h = 4 * c
    w = {"": 2 * c * h * 2, "fc1": c * h + h * c * 2, "full": 2 * c * h}[mode]
    vec = 4 * (2 * h + 2 * c + (2 * c if post else 0)) + (4 * c if mode == "full" else 0)
    half = 8 * rows * c * c
    ops = {"": {BF16: 2 * half}, "fc1": {INT8: half, BF16: half}, "full": {INT8: 2 * half}}[mode]
    return bound(3 * rows * c * 2 + w + vec, ops)


def two_products(torch, blk):
    """cuBLAS's two bf16 products of a block tail at hid = 4C, as one
    PyTorch call each (the [R, 4C] hidden through device memory): K1's
    library yardstick."""
    w1 = blk.mlp.fc1.weight.t().contiguous()
    w2 = blk.mlp.fc2.weight.t().contiguous()
    return lambda y: torch.matmul(torch.matmul(y, w1), w2)


def k4_products(torch, folded, rows: int, c: int, dev, g):
    """K4's two products at its shapes as one PyTorch call each, the [R, 4C]
    hidden through device memory: torch._int_mm (s8 x s8 -> s32) for fc1,
    then torch._int_mm again ('full') or a bf16 torch.matmul ('fc1') for
    fc2, on a hidden made beforehand: K4's library yardstick."""
    yq = torch.randint(-127, 128, (rows, c), device=dev, generator=g, dtype=torch.int8)
    w1 = folded.wq1.t()
    if folded.mode == "full":
        hq = torch.randint(-127, 128, (rows, 4 * c), device=dev, generator=g, dtype=torch.int8)
        w2 = folded.wq2.t()
        return lambda: (torch._int_mm(yq, w1), torch._int_mm(hq, w2))
    hb = torch.randn(rows, 4 * c, device=dev, generator=g).to(torch.bfloat16)
    return lambda: (torch._int_mm(yq, w1), torch.matmul(hb, folded.w2g))


def check_k1_shape(torch, km, what, blk, dr, xr, posts, tiers, planted) -> float:
    """K1 against its plain version at one shape: every post-LN variant and
    GELU tier, with x and with x = 0 (the MLP branch alone), and the planted
    faults when asked. Returns the largest max|diff|."""
    c = xr.shape[-1]
    folded = blk.fold()
    zero = torch.zeros_like(xr)
    o_max = km.ln_mlp_residual_plain(dr, zero, folded).float().abs().max().item()
    worst = 0.0
    for post in posts:
        for tier in tiers:
            for xin in (xr, zero):
                tag = (f"{what} post_ln={int(post is not None)} gelu={tier:7s} "
                       f"x={'0' if xin is zero else 'randn'}")
                ref = km.ln_mlp_residual_plain(dr, xin, folded, post, tier)
                out = km.ln_mlp_residual(dr, xin, folded, post, tier)
                if post is None:   # out = x + bf16(o)
                    err, rel, ulps = compare(torch, km, tag, out, ref, xin, o_max)
                else:              # out = LN(x + o): the output's own scale
                    err, rel, ulps = compare(torch, km, tag, out, ref, None,
                                             ref.float().abs().max().item())
                worst = max(worst, err)
                log(f"{tag} max|diff|={err:.3e} rel={rel:.3e} ulps={ulps:.3f}")
    if planted:   # the check refuses a wrong MLP
        for xin in (xr, zero):
            ref = km.ln_mlp_residual_plain(dr, xin, folded)
            for name, bad in planted_folds(torch, km, blk).items():
                out = km.ln_mlp_residual(dr, xin, bad)
                log(f"  C={c} planted, x={'0' if xin is zero else 'randn'}: "
                    + must_fail(torch, km, name, out, ref, xin, o_max))
    return worst


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


def planted_int8(torch, k4, blk, folded, mode: str) -> dict:
    """K4's folds, each with one term wrong, as a kernel that forgot it
    would compute."""
    args = list(blk._fold_args())
    args[1] = torch.zeros_like(args[1])      # the LN bias
    return {"b2g dropped": folded._replace(b2g=torch.zeros_like(folded.b2g)),
            "LN-bias fold dropped": k4.fold_block_mlp_int8(*args, mode, torch.bfloat16),
            "s1 by its mean": folded._replace(
                s1=folded.s1.mean().expand_as(folded.s1).contiguous())}


def check_k4_shape(torch, km, k4, tag, blk, dr, xr, posts, tiers, planted, acc, g) -> None:
    """K4 in both modes at one (call, stage) shape against its plain
    version, as K1: with and without the post-LN, x and x = 0; the planted
    faults when asked; times of kernel, plain, K1 and the library's two
    products (k4_products) at the shape."""
    c = xr.shape[-1]
    zero = torch.zeros_like(xr)
    for mode in k4.MODES:
        folded = blk.fold_int8(mode)
        o_max = k4.ln_mlp_residual_int8_plain(dr, zero, folded).float().abs().max().item()
        for post in posts:
            for tier in tiers:
                for xin in (xr, zero):
                    what = (f"K4 {mode:4s} {tag} post_ln={int(post is not None)} "
                            f"gelu={tier:7s} x={'0' if xin is zero else 'randn'}")
                    ref = k4.ln_mlp_residual_int8_plain(dr, xin, folded, post, tier)
                    out = k4.ln_mlp_residual_int8(dr, xin, folded, post, tier)
                    if post is None:
                        r = compare(torch, km, what, out, ref, xin, o_max, k4.ULP_TOL)
                    else:
                        r = compare(torch, km, what, out, ref, None,
                                    ref.float().abs().max().item(), k4.ULP_TOL)
                    acc[mode]["err"] = max(acc[mode]["err"], r[0])
                    acc[mode]["ulps"] = max(acc[mode]["ulps"], r[2])
                    log(f"{what} max|diff|={r[0]:.3e} rel={r[1]:.3e} ulps={r[2]:.3f}")
        if planted:
            for xin in (xr, zero):
                ref = k4.ln_mlp_residual_int8_plain(dr, xin, folded)
                for name, bad in planted_int8(torch, k4, blk, folded, mode).items():
                    out = k4.ln_mlp_residual_int8(dr, xin, bad)
                    msg = must_fail(torch, km, name, out, ref, xin, o_max, k4.ULP_TOL)
                    acc[mode]["planted_min"] = min(acc[mode]["planted_min"],
                                                   km.bf16_ulp_error(out, ref, xin, o_max))
                    log(f"  K4 {mode} C={c} planted, x={'0' if xin is zero else 'randn'}: {msg}")
        iters = 20 if dr.numel() < 2e7 else 10
        rows = dr.numel() // c
        t_k = cuda_ms(torch, lambda: k4.ln_mlp_residual_int8(dr, xr, folded), iters)
        t_p = cuda_ms(torch, lambda: k4.ln_mlp_residual_int8_plain(dr, xr, folded), 3, 1)
        f1 = blk.fold()
        t_1 = cuda_ms(torch, lambda: km.ln_mlp_residual(dr, xr, f1), iters)
        prods = k4_products(torch, folded, rows, c, dr.device, g)
        t_l = cuda_ms(torch, prods, iters)
        b, by = mlp_bound(rows, c, mode)
        acc[mode]["shapes"].append((tag, t_k, t_p, t_1, t_l, b, by))
        del folded, f1, prods


def phase_k1_wide(torch, km, k4, dev, card: str, g) -> tuple:
    """K1 and K4 (both modes) at the widths past convnext_tiny's (K1_WIDE),
    at the ED call's rows for each: held as at the tiny shapes (post-LN where
    the stage has one, x = 0, the planted faults) and timed beside their
    plain versions, the library's products and the bound. Returns K1's
    largest max|diff| and K4's record of these shapes."""
    from genconvit_tpu_torch.models.convnext import CONVNEXT_CFGS, _nhwc

    worst = 0.0
    k4acc = {m: {"err": 0.0, "ulps": 0.0, "planted_min": float("inf"), "shapes": []}
             for m in k4.MODES}
    for name, si, c in K1_WIDE:
        if CONVNEXT_CFGS[f"convnext_{name}"]["dims"][si] != c:
            raise AssertionError(f"convnext_{name} stage {si} is not C={c}")
        n, px = CALLS[0][1], CALLS[0][2]
        h = (px // 4) >> si
        blk = random_block(torch, c, dev, g)
        x = torch.randn(n, c, h, h, device=dev, generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            dr, xr = _nhwc(blk.dw(x)), _nhwc(x)
            rows = dr.numel() // c
            plan = km.mlp_plan(c)
            posts = [None]
            if si < 3:
                posts.append(((1 + 0.1 * torch.randn(c, device=dev, generator=g)).float(),
                              (0.1 * torch.randn(c, device=dev, generator=g)).float()))
            worst = max(worst, check_k1_shape(
                torch, km, f"K1 {name:5s} s{si} R={rows:7d} C={c:4d} ragged="
                f"{int(rows % plan.rows != 0)}", blk, dr, xr, posts, ("default",), True))
            check_k4_shape(torch, km, k4, f"{name:5s} s{si} R={rows:7d} C={c:4d}", blk, dr, xr,
                           posts, ("default",), True, k4acc, g)
            folded = blk.fold()
            yb = torch.randn(rows, c, device=dev, generator=g).to(torch.bfloat16)
            prods = two_products(torch, blk)
            t_k = cuda_ms(torch, lambda: km.ln_mlp_residual(dr, xr, folded), 5)
            t_p = cuda_ms(torch, lambda: km.ln_mlp_residual_plain(dr, xr, folded), 3, 1)
            t_l = cuda_ms(torch, lambda: prods(yb), 5)
        bd, by = mlp_bound(rows, c, "")
        log(f"K1 time {name:5s} s{si} R={rows:7d} C={c:4d} (plan {tuple(plan)}, "
            f"{plan.passes(c)} pass(es){', streamed' if plan.streams(c) else ''}): kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, cuBLAS's two products {t_l:.4f} ms, bound "
            f"{bd:.4f} ms ({by}) [{card}]")
        del blk, x, dr, xr, folded, yb, prods
        torch.cuda.empty_cache()
    return worst, k4acc


def phase_k3(torch, km, k3, dev, card: str) -> dict:
    """K3 at M = 1, 15, 30, 120 and 240 on the full latent head, and one odd
    shape; planted faults at each."""
    import torch.nn.functional as F

    from genconvit_tpu_torch.ops.quant import quantize_wint8

    g = torch.Generator(device=dev).manual_seed(4321)
    k, n = LATENT
    w16 = (0.01 * torch.randn(n, k, device=dev, generator=g)).to(torch.bfloat16)
    wq, sc = quantize_wint8(w16, dim=1)
    b = 0.1 * torch.randn(n, device=dev, generator=g)
    b16 = b.to(torch.bfloat16)
    rec = {"err": 0.0, "ulps": 0.0, "planted_min": float("inf"), "shapes": []}
    odd = 0.01 * torch.randn(300, 1000, device=dev, generator=g)
    oq, osc = quantize_wint8(odd, dim=1)
    ob = 0.1 * torch.randn(300, device=dev, generator=g)
    # the odd shape, then the head at V = 1/15, 1, 2 and 8 videos and at 240
    # rows (two x tiles' worth: the widest tile)
    for m, (wq_, sc_, b_) in ((7, (oq, osc, ob)), (1, (wq, sc, b)), (15, (wq, sc, b)),
                              (30, (wq, sc, b)), (120, (wq, sc, b)), (240, (wq, sc, b))):
        kk = wq_.shape[1]
        x = torch.randn(m, kk, device=dev, generator=g).to(torch.bfloat16)
        what = f"K3 M={m:3d} K={kk:5d} N={wq_.shape[0]:5d}"
        ref = k3.matmul_wint8_plain(x, wq_, sc_, b_)
        out = k3.matmul_wint8(x, wq_, sc_, b_)
        err, rel, ulps = compare(torch, km, what, out, ref)
        rec["err"] = max(rec["err"], err)
        rec["ulps"] = max(rec["ulps"], ulps)
        r32 = k3.matmul_wint8_plain(x.float(), wq_, sc_, b_)
        e32 = ((k3.matmul_wint8(x.float(), wq_, sc_, b_) - r32).abs().max()
               / r32.abs().max()).item()
        if not e32 <= 1e-5:
            raise AssertionError(f"{what} float32 output: max|diff|/max|ref| {e32:.3e} > 1e-5")
        log(f"{what} max|diff|={err:.3e} rel={rel:.3e} ulps={ulps:.3f}; f32 out rel {e32:.2e}")
        for name, bad in (("bias dropped", (wq_, sc_, torch.zeros_like(b_))),
                          ("scale by its mean", (wq_, sc_.mean().expand_as(sc_).contiguous(), b_))):
            bo = k3.matmul_wint8(x, *bad)
            rec["planted_min"] = min(rec["planted_min"], km.bf16_ulp_error(bo, ref))
            log(f"  K3 M={m} planted: " + must_fail(torch, km, name, bo, ref))
        if kk == k:
            t_k = cuda_ms(torch, lambda: k3.matmul_wint8(x, wq, sc, b), 20)
            t_p = cuda_ms(torch, lambda: k3.matmul_wint8_plain(x, wq, sc, b), 5)
            t_l = cuda_ms(torch, lambda: F.linear(x, w16, b16), 20)
            bd, by = bound(m * k * 2 + n * k + 8 * n + m * n * 2, {BF16: 2 * m * k * n})
            rec["shapes"].append((m, t_k, t_p, t_l, bd, by))
            log(f"K3 time M={m}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, F.linear on the "
                f"bf16 head {t_l:.4f} ms, bound {bd:.4f} ms ({by}) [{card}]")
    return rec


def phase_kernels(torch, dev, card: str) -> list:
    import torch.nn.functional as F

    from genconvit_tpu_torch.models.convnext import _nhwc
    from genconvit_tpu_torch.ops.act import gelu
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
    from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4
    from genconvit_tpu_torch.ops.cuda import int8_matmul as k3
    from genconvit_tpu_torch.ops.norm import layer_norm

    g = torch.Generator(device=dev).manual_seed(1234)
    k1_ms = k1_plain_ms = k1_graph_ms = k1_lib_ms = k1_bound = 0.0
    k1_sides = []
    k1_err = 0.0
    k4acc = {m: {"err": 0.0, "ulps": 0.0, "planted_min": float("inf"), "shapes": []}
             for m in k4.MODES}
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
                post_variants = [None]
                if si < 3:
                    post_variants.append((
                        (1 + 0.1 * torch.randn(c, device=dev, generator=g)).float(),
                        (0.1 * torch.randn(c, device=dev, generator=g)).float()))
                tiers = ("default", "hp") if (call, si) == ("ed", 1) else ("default",)
                k1_err = max(k1_err, check_k1_shape(
                    torch, km, f"K1 {call:8s} s{si} R={rows:7d} C={c:3d} ragged={ragged}", blk,
                    dr, xr, post_variants, tiers, call == "ed"))
                check_k4_shape(torch, km, k4, f"{call:8s} s{si} R={rows:7d} C={c:3d}", blk,
                               dr, xr, post_variants, tiers, call == "ed", k4acc, g)

                def graph_tail():
                    t = layer_norm(dr, blk.norm.weight, blk.norm.bias, 1e-6)
                    t = gelu(F.linear(t, blk.mlp.fc1.weight, blk.mlp.fc1.bias))
                    t = F.linear(t, blk.mlp.fc2.weight, blk.mlp.fc2.bias)
                    return xr + t * blk.gamma

                iters = 20 if rows * c < 2e7 else 10
                yb = torch.randn(rows, c, device=dev, generator=g).to(torch.bfloat16)
                prods = two_products(torch, blk)
                t_k = cuda_ms(torch, lambda: km.ln_mlp_residual(dr, xr, folded), iters)
                t_p = cuda_ms(torch, lambda: km.ln_mlp_residual_plain(dr, xr, folded), iters)
                t_g = cuda_ms(torch, graph_tail, iters)
                t_l = cuda_ms(torch, lambda: prods(yb), iters)
                del yb, prods
            bd, by = mlp_bound(rows, c, "")
            log(f"K1 time {call:8s} s{si} R={rows:7d} C={c:3d}: kernel {t_k:.4f} ms, "
                f"plain {t_p:.4f} ms, plain bf16 graph {t_g:.4f} ms, cuBLAS's two products "
                f"{t_l:.4f} ms, bound {bd:.4f} ms ({by}) [{card}]")
            k1_bound += DEPTHS[si] * bd
            k1_sides.append((DEPTHS[si] * bd, by))
            k1_ms += DEPTHS[si] * t_k
            k1_plain_ms += DEPTHS[si] * t_p
            k1_graph_ms += DEPTHS[si] * t_g
            k1_lib_ms += DEPTHS[si] * t_l
            del blk, x, d, dr, xr, folded
    log(f"K1 per V=8 ensemble forward (54 launches, depth-weighted): kernel "
        f"{k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, plain bf16 graph "
        f"{k1_graph_ms:.4f} ms, cuBLAS's two products {k1_lib_ms:.4f} ms, bound "
        f"{k1_bound:.4f} ms [{card}]")
    k1_wide_err, k4wide = phase_k1_wide(torch, km, k4, dev, card, g)
    k1_err = max(k1_err, k1_wide_err)
    k4tot = {}
    for mode, rec in k4acc.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "k1_ms": 0.0, "lib_ms": 0.0, "bound_ms": 0.0}
        for i, (tag, t_k, t_p, t_1, t_l, bd, by) in enumerate(rec["shapes"]):
            depth = DEPTHS[i % 4]
            tot["ms"] += depth * t_k
            tot["plain_ms"] += depth * t_p
            tot["k1_ms"] += depth * t_1
            tot["lib_ms"] += depth * t_l
            tot["bound_ms"] += depth * bd
            log(f"K4 {mode:4s} time {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, K1 "
                f"{t_1:.4f} ms, library's two products {t_l:.4f} ms, bound {bd:.4f} ms ({by}) "
                f"[{card}]")
        for tag, t_k, t_p, t_1, t_l, bd, by in k4wide[mode]["shapes"]:
            log(f"K4 {mode:4s} time {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, K1 "
                f"{t_1:.4f} ms, library's two products {t_l:.4f} ms, bound {bd:.4f} ms ({by}) "
                f"[{card}]")
        rec["err"] = max(rec["err"], k4wide[mode]["err"])
        rec["ulps"] = max(rec["ulps"], k4wide[mode]["ulps"])
        rec["planted_min"] = min(rec["planted_min"], k4wide[mode]["planted_min"])
        log(f"K4 {mode} per V=8 ensemble forward (54 launches, depth-weighted): kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, K1 {tot['k1_ms']:.4f} ms, "
            f"library's two products {tot['lib_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms; "
            f"max ulps {rec['ulps']:.3f} (limit {k4.ULP_TOL}, every width); planted faults >= "
            f"{rec['planted_min']:.1f} ulps [{card}]")
        k4tot[mode] = tot

    k2_ms = k2_plain_ms = k2_lib_ms = k2_bound = 0.0
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
        s16, b16 = s.to(torch.bfloat16), b.to(torch.bfloat16)
        t_k = cuda_ms(torch, lambda: km.layer_norm_rows(x, s, b), 20)
        t_p = cuda_ms(torch, lambda: km.layer_norm_rows_plain(x, s, b), 20)
        t_l = cuda_ms(torch, lambda: F.layer_norm(x, (c,), s16, b16, 1e-6), 20)
        rows = x.numel() // c
        bd, by = bound(2 * rows * c * 2 + 8 * c, {FP32: 8 * rows * c})
        k2_ms += t_k
        k2_plain_ms += t_p
        k2_lib_ms += t_l
        k2_bound += bd
        log(f"K2 {call:8s} R={rows:7d} C={c}: max|diff|={err:.3e} "
            f"rel={rel:.3e} ulps={ulps:g}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"F.layer_norm {t_l:.4f} ms, bound {bd:.4f} ms ({by}) [{card}]")
    log(f"K2 per V=8 ensemble forward (3 launches): kernel {k2_ms:.4f} ms, "
        f"plain {k2_plain_ms:.4f} ms, F.layer_norm {k2_lib_ms:.4f} ms, bound "
        f"{k2_bound:.4f} ms [{card}]")
    # K2 at each instantiation: the stem widths' own and the generic one
    # (one width past its 1024 columns in registers), rows ragged against a
    # block's rows, the planted bias drop at each
    for c in K2_CHECK_WIDTHS:
        plan, lib = km.k2_plan(c), km.library_k2_plan(c)
        if plan != lib:
            raise AssertionError(f"K2's instantiation mirror at C={c}: {plan}, the library's {lib}")
        x = (3 * torch.randn(K2_CHECK_ROWS, c, device=dev, generator=g) + 0.5).to(torch.bfloat16)
        s = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).float()
        b = (0.1 * torch.randn(c, device=dev, generator=g)).float()
        ref = km.layer_norm_rows_plain(x, s, b)
        err, rel, ulps = compare(torch, km, f"K2 C={c}", km.layer_norm_rows(x, s, b), ref)
        k2_err = max(k2_err, err)
        log(f"K2 C={c} R={K2_CHECK_ROWS} {tuple(plan)} (lanes, chunks, generic): "
            f"max|diff|={err:.3e} rel={rel:.3e} ulps={ulps:g}; "
            + must_fail(torch, km, "LN bias dropped", km.layer_norm_rows(x, s, 0 * b), ref))
    k3rec = phase_k3(torch, km, k3, dev, card)
    m120 = [r for r in k3rec["shapes"] if r[0] == 120][0]
    log(f"K3 per V=8 ensemble forward (1 launch, M=120): kernel {m120[1]:.4f} ms, plain "
        f"{m120[2]:.4f} ms, F.linear {m120[3]:.4f} ms, bound {m120[4]:.4f} ms; max ulps "
        f"{k3rec['ulps']:.3f}; planted faults >= {k3rec['planted_min']:.1f} ulps [{card}]")
    mlp = "genconvit_tpu/ops/pallas/convnext_mlp.py"
    rec = [
        {"name": "ln_mlp_residual", "route": "cuda",
         "source": "genconvit_tpu_torch/csrc/convnext_mlp.cu", "replaces": f"{mlp}:74",
         "launches": 0, "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": k1_lib_ms},
        {"name": "layer_norm_rows", "route": "cuda",
         "source": "genconvit_tpu_torch/csrc/layer_norm_rows.cu", "replaces": f"{mlp}:244",
         "launches": 0, "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": "bytes", "library_ms": k2_lib_ms},
        {"name": "matmul_wint8", "route": "cuda",
         "source": "genconvit_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "genconvit_tpu/ops/pallas/int8_matmul.py:30",
         "launches": 0, "max_abs_err": k3rec["err"], "ms": m120[1], "plain_ms": m120[2],
         "bound_ms": m120[4], "bound_by": m120[5], "library_ms": m120[3]},
    ]
    for mode, line in (("fc1", 189), ("full", 137)):
        tot = k4tot[mode]
        rec.append(
            {"name": f"ln_mlp_residual_int8[{mode}]", "route": "cuda",
             "source": "genconvit_tpu_torch/csrc/convnext_mlp_int8.cu",
             "replaces": f"{mlp}:{line}", "launches": 0,
             "max_abs_err": k4acc[mode]["err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
             "bound_ms": tot["bound_ms"], "bound_by": "bytes", "library_ms": tot["lib_ms"]})
    rec[0]["bound_by"] = side(k1_sides)
    for r, mode in ((rec[3], "fc1"), (rec[4], "full")):
        r["bound_by"] = side([(DEPTHS[i % 4] * sh[5], sh[6])
                              for i, sh in enumerate(k4acc[mode]["shapes"])])
    return rec


def fused_shapes() -> tuple:
    """K5's (call, n, H, C, launches per forward) and K6's (call, n, H, C,
    blocks) on the scoring path, by the port's own rules."""
    from genconvit_tpu_torch.models.convnext import (block_kernel_applies,
                                                     stage_kernel_applies)

    k5, k6 = [], []
    for call, n, px in CALLS:
        for si, c in enumerate(DIMS):
            h = (px // 4) >> si
            if block_kernel_applies(h):
                k5.append((call, n, h, c, DEPTHS[si]))
            if stage_kernel_applies(h, c):
                k6.append((call, n, h, c, DEPTHS[si]))
    if sum(s[4] for s in k5) != K5_PER_FORWARD or len(k6) != K6_PER_FORWARD:
        raise AssertionError(f"fused launch plan {k5} {k6} is not {K5_PER_FORWARD} K5 + "
                             f"{K6_PER_FORWARD} K6 launches per forward")
    return k5, k6


def random_fused_block(torch, c: int, dev, g):
    """random_block with a non-zero depthwise bias (timm's init is zero,
    which would hide a kernel that drops it)."""
    blk = random_block(torch, c, dev, g)
    with torch.no_grad():
        blk.conv_dw.bias.copy_(0.1 * torch.randn(c, device=dev, generator=g))
    return blk


def fused_bound(rows: int, c: int, blocks: int) -> tuple:
    """Bound of one K5 launch (blocks=1) or K6 chain: the activation in and
    out once (bf16) and every block's weights once; per block 16*R*C^2 bf16
    operations of the two matmuls on the tensor cores and, at the same time
    on the f32 cores, 98*R*C operations of the taps."""
    w = blocks * (49 * c * 2 + 2 * 4 * c * c * 2 + 4 * (6 * c + 4 * c))
    return bound(2 * rows * c * 2 + w, {BF16: blocks * 16 * rows * c * c},
                 {FP32: blocks * 98 * rows * c})


def fused_steps(k5, k6, name: str, kern, x, p, truth=None):
    """(input, kernel output, plain output) of each check: K5's one block,
    or K6's chain block by block (convnext_stage.stage_steps)."""
    if name == "K6":
        return k6.stage_steps(kern, x, p, truth)
    ref = k5.fused_convnext_block_plain(x, p if truth is None else truth)
    return iter([(x, kern(x, p), ref)])


def check_fused(torch, dev, card: str, g, name: str, call: str, n: int, h: int, c: int,
                nb: int, time_plain: bool = True) -> dict:
    """One K5 launch (nb = 1) or K6 chain of nb blocks at [n, h, h, c]
    against its plain version (K6 block by block), with the planted faults;
    CUDA-event times of kernel, plain version (unless time_plain is False)
    and cuDNN's depthwise conv + K1 over the same blocks, and the bound."""
    from genconvit_tpu_torch.models.convnext import _nhwc
    from genconvit_tpu_torch.ops.cuda import convnext_block as k5
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
    from genconvit_tpu_torch.ops.cuda import convnext_stage as k6

    tol = k5.ULP_TOL   # per block, K6's too
    rec = {"err": 0.0, "ulps": 0.0, "planted_min": float("inf")}
    blks = [random_fused_block(torch, c, dev, g) for _ in range(nb)]
    x = torch.randn(n, h, h, c, device=dev, generator=g).to(torch.bfloat16)
    with torch.inference_mode():
        packs = [b.pack_fused() for b in blks]
        if name == "K5":
            p = packs[0]
            kern, plain = k5.fused_convnext_block, k5.fused_convnext_block_plain
            faults = k5.planted_faults(p)
        else:
            p = k5.stack_blocks(packs)
            kern, plain = k6.fused_convnext_stage, k6.fused_convnext_stage_plain
            faults = k6.chain_faults(packs)
        what = f"{name} {call:8s} N={n} H={h:2d} C={c:4d} blocks={nb}"
        for k, (xin, out, ref) in enumerate(fused_steps(k5, k6, name, kern, x, p)):
            scale = (ref.float() - xin.float()).abs().max().item()
            step = what + (f" block {k}" if name == "K6" else "")
            err, rel, ulps = compare(torch, km, step, out, ref, xin, scale, tol)
            rec["err"] = max(rec["err"], err)
            rec["ulps"] = max(rec["ulps"], ulps)
            log(f"{step} max|diff|={err:.3e} rel={rel:.3e} ulps={ulps:.3f} (limit {tol})")
        for fname, bad in faults.items():
            # refused when any step fails; the steps after it are not run
            worst = 0.0
            for k, (xin, out, ref) in enumerate(fused_steps(k5, k6, name, kern, x, bad, p)):
                scale = (ref.float() - xin.float()).abs().max().item()
                worst = max(worst, km.bf16_ulp_error(out, ref, xin, scale))
                if worst > tol:
                    break
            rec["planted_min"] = min(rec["planted_min"], worst)
            log(f"  {name} planted: "
                + must_fail(torch, km, fname + (f" (block {k})" if name == "K6" else ""),
                            out, ref, xin, scale, tol))
        del xin, ref, out, faults
        folds = [b.fold() for b in blks]
        xc = x.permute(0, 3, 1, 2)   # the NCHW channels_last view

        def cudnn_dw_k1():
            v = xc
            for b, f in zip(blks, folds):
                v = km.ln_mlp_residual(_nhwc(b.dw(v)), _nhwc(v), f).permute(0, 3, 1, 2)
            return v

        iters = 10 if n * h * h * c * nb < 5e7 else 5
        rec["ms"] = cuda_ms(torch, lambda: kern(x, p), iters)
        rec["plain_ms"] = cuda_ms(torch, lambda: plain(x, p), 2, 1) if time_plain else None
        rec["cmp_ms"] = cuda_ms(torch, cudnn_dw_k1, iters)
    rec["bound_ms"], rec["by"] = fused_bound(n * h * h, c, nb)
    plain_ms = "not timed" if rec["plain_ms"] is None else f"{rec['plain_ms']:.4f} ms"
    log(f"{name} time {call:8s} N={n} H={h:2d} C={c:4d} blocks={nb}: kernel {rec['ms']:.4f} ms, "
        f"plain {plain_ms}, cuDNN dw + K1 {rec['cmp_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['by']}) [{card}]")
    return rec


def phase_fused(torch, dev, card: str) -> list:
    """K5 and K6 at the scoring path's shapes against their plain versions
    (K6 block by block), with planted faults; times of kernel, plain version
    and the cuDNN depthwise conv + K1 at the same shapes; the bound. Then K6
    at convnext_large's and convnext_base's widths (K6_WIDE), held and timed
    the same way, and both kernels' plans against the library's."""
    from genconvit_tpu_torch.ops.cuda import convnext_block as k5
    from genconvit_tpu_torch.ops.cuda import convnext_stage as k6

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(2345)
    k5_shapes, k6_chains = fused_shapes()
    for name, shapes in (("K5", k5_shapes), ("K6", k6_chains + [
            (f"ED {m}", 240, h, c, K6_WIDE_BLOCKS) for m, _, h, c in K6_WIDE])):
        for _, n, h, c, _ in shapes:
            plan, lib = k6.k6_plan(c, n, h, h, sms), k6.library_k6_plan(c, n, h, h, sms)
            if plan != lib or tuple(plan[:5]) != tuple(k5.k5_plan(c)) or \
                    tuple(k5.library_k5_plan(c)) != tuple(k5.k5_plan(c)):
                raise AssertionError(f"{name}'s plan mirror at C={c} N={n} H={h}: {plan}, the "
                                     f"library's {lib}")
            log(f"{name} plan C={c} N={n} H={h}: {tuple(plan)} (rows, group columns, stages, "
                f"shared bytes, pairs a lane, images an item)")
    recs = {}
    for name, shapes in (("K5", k5_shapes), ("K6", k6_chains)):
        tot = {"err": 0.0, "ulps": 0.0, "planted_min": float("inf"), "ms": 0.0,
               "plain_ms": 0.0, "cmp_ms": 0.0, "bound_ms": 0.0, "sides": []}
        for call, n, h, c, depth in shapes:
            nb = 1 if name == "K5" else depth    # blocks per launch
            per_fwd = depth if name == "K5" else 1
            r = check_fused(torch, dev, card, g, name, call, n, h, c, nb)
            for key in ("err", "ulps"):
                tot[key] = max(tot[key], r[key])
            tot["planted_min"] = min(tot["planted_min"], r["planted_min"])
            for key in ("ms", "plain_ms", "cmp_ms", "bound_ms"):
                tot[key] += per_fwd * r[key]
            tot["sides"].append((per_fwd * r["bound_ms"], r["by"]))
            log(f"  x{per_fwd} per forward")
        launches = K5_PER_FORWARD if name == "K5" else K6_PER_FORWARD
        log(f"{name} per V=8 ensemble forward ({launches} launches): kernel {tot['ms']:.4f} ms, "
            f"plain {tot['plain_ms']:.4f} ms, cuDNN dw + K1 {tot['cmp_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({side(tot['sides'])}); max ulps {tot['ulps']:.3f}; "
            f"planted faults >= {tot['planted_min']:.1f} ulps [{card}]")
        recs[name] = tot
    for model, stage, h, c in K6_WIDE:
        r = check_fused(torch, dev, card, g, "K6", f"ED {model} s{stage}", 240, h, c,
                        K6_WIDE_BLOCKS, time_plain=False)
        recs["K6"]["err"] = max(recs["K6"]["err"], r["err"])
        log(f"K6 {model} stage {stage} (C={c}, {K6_WIDE_BLOCKS} blocks): kernel {r['ms']:.4f} ms "
            f"against cuDNN dw + K1 {r['cmp_ms']:.4f} ms ({r['ms'] / r['cmp_ms']:.2f}x), bound "
            f"{r['bound_ms']:.4f} ms; max ulps {r['ulps']:.3f}; planted faults >= "
            f"{r['planted_min']:.1f} ulps [{card}]")
    out = []
    for name, fn, src, tpu in (
            ("K5", "fused_convnext_block", "convnext_block.cu",
             "genconvit_tpu/ops/pallas/convnext_block.py:44"),
            ("K6", "fused_convnext_stage", "convnext_stage.cu",
             "genconvit_tpu/ops/pallas/convnext_stage.py:53")):
        r = recs[name]
        out.append({"name": fn, "route": "cuda", "source": f"genconvit_tpu_torch/csrc/{src}",
                    "replaces": tpu, "launches": 0, "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": side(r["sides"]), "library_ms": None})
    return out


def k7_shapes(name: str, n: int, px: int = IMG) -> list:
    """(stage, grid, B, heads, hd, window, nW, blocks with a mask, blocks
    without) of K7 in one Swin forward of n images, by the port's own rule
    (swin.block_window)."""
    from genconvit_tpu_torch.models.swin import SWIN_CFGS, block_window

    cfg = SWIN_CFGS[name]
    hw, dim, out = px // 4, cfg["embed_dim"], []
    for si, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        geo = [block_window((hw, hw), cfg["window"], bi) for bi in range(depth)]
        w, masked = geo[0][0], sum(shift > 0 for _, shift in geo)
        nw = (hw // w) ** 2
        out.append((si, hw, n * nw, heads, dim // heads, w, nw, masked, depth - masked))
        hw, dim = hw // 2, dim * 2
    return out


def k7_bound(b: int, l: int, heads: int, hd: int, nw: int, masked: bool) -> tuple:
    """Bound of one K7 launch: qkv in and the output out once (bf16), the
    bias (and the mask) once (f32); 4*L^2*hd bf16 operations of the two
    products per window-head on the tensor cores and, beside them, ~8 f32
    operations per score of the softmax (scale, bias, mask, max, subtract,
    exp, sum, divide)."""
    g = b * heads
    nbytes = 2 * b * l * 4 * heads * hd + 4 * l * l * (heads + (nw if masked else 0))
    return bound(nbytes, {BF16: 4 * l * l * hd * g}, {FP32: 8 * l * l * g})


def k7_inputs(torch, np, dev, g, b: int, hw: int, w: int, heads: int, hd: int):
    """qkv [B, L, 3C] bf16, a bias gathered from a random O(1) table as the
    model gathers it, and the shifted-window mask of an hw x hw grid."""
    from genconvit_tpu_torch.models.swin import relative_position_index, shifted_window_mask

    l = w * w
    qkv = torch.randn(b, l, 3 * heads * hd, device=dev, generator=g).to(torch.bfloat16)
    table = torch.randn((2 * w - 1) ** 2, heads, device=dev, generator=g)  # O(1)
    idx = torch.from_numpy(relative_position_index(w).reshape(-1).astype(np.int64))
    bias = table[idx.to(dev)].view(l, l, heads).permute(2, 0, 1).contiguous()
    mask = torch.from_numpy(shifted_window_mask(hw, hw, w, w // 2)).to(dev)
    return qkv, bias, mask


def check_k7(torch, k7, what: str, qkv, bias, m, heads: int, wpm: int, nw: int, rec: dict) -> None:
    """K7 against its plain version (finite, REL_TOL, k7.ULP_TOL ulps of the
    window-head's largest |out|), its plan against the library's, and every
    planted fault refused; rec keeps the largest error and ulps and the
    smallest planted ulps."""
    b, l, c3 = qkv.shape
    hd = c3 // (3 * heads)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = k7.k7_plan(l, heads, hd, m is not None, b, sms)
    lib = k7.library_k7_plan(l, heads, hd, m is not None, b, sms)
    if plan != lib:
        raise AssertionError(f"{what}: K7's plan mirror {plan}, the library's {lib}")
    ref = k7.window_attention_plain(qkv, bias, m, heads, wpm)
    out = k7.window_attention(qkv, bias, m, heads, wpm)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    ulps = k7.ulp_error(out, ref, heads)
    if not (torch.isfinite(out).all() and rel <= REL_TOL and ulps <= k7.ULP_TOL):
        raise AssertionError(f"{what}: max|diff| {err:.3e}, /max|ref| {rel:.3e} "
                             f"(limit {REL_TOL}), {ulps} ulps (limit {k7.ULP_TOL})")
    rec["err"], rec["ulps"] = max(rec["err"], err), max(rec["ulps"], ulps)
    log(f"{what} max|diff|={err:.3e} rel={rel:.3e} ulps={ulps:.3f}; plan {tuple(plan)} "
        f"(G, strips, teams, stages, shared bytes, threads, blocks)")
    for fname, bad in k7.planted_outputs(k7.window_attention, qkv, bias, m, heads, nw).items():
        bu = k7.ulp_error(bad, ref, heads)
        if bu <= k7.ULP_TOL:
            raise AssertionError(f"planted fault {fname} passed the check ({bu} ulps)")
        rec["planted_min"] = min(rec["planted_min"], bu)
        log(f"  K7 planted: {fname}: {bu:.1f} ulps -> refused")


def phase_k7(torch, dev, card: str) -> dict:
    """K7 at the stage shapes of swin_tiny and swin_large at N=120 against its
    plain version, with planted faults; times of kernel, plain version and
    SDPA, the bound; per forward by the blocks of each shape."""
    import numpy as np
    import torch.nn.functional as F

    from genconvit_tpu_torch.ops.cuda import window_attn as k7

    g = torch.Generator(device=dev).manual_seed(3456)
    rec = {"err": 0.0, "ulps": 0.0, "planted_min": float("inf")}
    for name in (SWIN_TINY, SWIN_LARGE):
        tot = {"ms": 0.0, "plain_ms": 0.0, "sdpa_ms": 0.0, "bound_ms": 0.0, "sides": []}
        shapes = k7_shapes(name, SWIN_BATCHES[0])
        for si, hw, b, heads, hd, w, nw, n_masked, n_plain in shapes:
            l = w * w
            qkv, bias, mask = k7_inputs(torch, np, dev, g, b, hw, w, heads, hd)
            variants = [(None, n_plain)]
            if n_masked:
                variants.insert(0, (mask, n_masked))
            q, k, v = qkv.view(b, l, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
            for m, per_fwd in variants:
                wpm = 1 if m is None else nw
                what = (f"K7 {name.split('_')[1]:5s} s{si} B={b:5d} heads={heads:2d} L={l} "
                        f"mask={int(m is not None)}")
                check_k7(torch, k7, what, qkv, bias, m, heads, wpm, nw, rec)
                # SDPA's operands, made outside the timing: the views of q, k,
                # v and bias + mask of each window as one bf16 float mask
                am = bias[None]
                if m is not None:
                    am = am + m[torch.arange(b, device=dev) % nw][:, None]
                am = am.to(torch.bfloat16)
                t_k = cuda_ms(torch, lambda: k7.window_attention(qkv, bias, m, heads, wpm), 20)
                t_p = cuda_ms(torch, lambda: k7.window_attention_plain(qkv, bias, m, heads, wpm),
                              5, 1)
                t_s = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am, scale=hd ** -0.5), 20)
                bd, by = k7_bound(b, l, heads, hd, nw, m is not None)
                log(f"K7 time {what}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, SDPA {t_s:.4f} "
                    f"ms, bound {bd:.4f} ms ({by}); x{per_fwd} per forward [{card}]")
                for key, t in (("ms", t_k), ("plain_ms", t_p), ("sdpa_ms", t_s), ("bound_ms", bd)):
                    tot[key] += per_fwd * t
                tot["sides"].append((per_fwd * bd, by))
                del am
            del qkv, q, k, v, bias, mask, variants
        launches = sum(s[7] + s[8] for s in shapes)
        log(f"K7 per {name} forward at N={SWIN_BATCHES[0]} ({launches} launches, "
            f"{sum(s[7] for s in shapes)} with a mask): kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, SDPA {tot['sdpa_ms']:.4f} ms, bound {tot['bound_ms']:.4f} "
            f"ms ({side(tot['sides'])}) [{card}]")
        rec[name] = tot
    # head widths 16 and 64 and windows of 16 tokens, B = 2 nW + 5 windows:
    # a work-item count ragged against the persistent grid
    for l, heads, hd, nw in K7_EXTRA:
        w = int(round(l ** 0.5))
        b = 2 * nw + 5
        qkv, bias, mask = k7_inputs(torch, np, dev, g, b, w * int(round(nw ** 0.5)), w, heads, hd)
        m = mask if nw > 1 else None
        check_k7(torch, k7, f"K7 L={l} heads={heads} hd={hd} B={b} mask={int(m is not None)}",
                 qkv, bias, m, heads, nw if m is not None else 1, max(nw, 4), rec)
    log(f"K7: max ulps {rec['ulps']:.3f} (limit {k7.ULP_TOL}); planted faults >= "
        f"{rec['planted_min']:.1f} ulps [{card}]")
    tiny = rec[SWIN_TINY]
    return {"name": "window_attention", "route": "cuda",
            "source": "genconvit_tpu_torch/csrc/window_attn.cu",
            "replaces": "genconvit_tpu/ops/pallas/window_attn.py:25", "launches": 0,
            "max_abs_err": rec["err"], "ms": tiny["ms"], "plain_ms": tiny["plain_ms"],
            "bound_ms": tiny["bound_ms"], "bound_by": side(tiny["sides"]),
            "library_ms": tiny["sdpa_ms"]}


def side(parts) -> str:
    """A per-forward bound is a sum of per-launch bounds: the side that sets
    the larger part of it."""
    ops = sum(t for t, by in parts if by == "operations")
    return "operations" if ops > sum(t for t, _ in parts) - ops else "bytes"


def check_verdicts(np, y, y_val, v: int) -> None:
    if y.shape != (v,) or y_val.shape != (v,):
        raise AssertionError(f"verdict shapes {y.shape}, {y_val.shape} != ({v},)")
    if not np.all(np.isfinite(y_val)):
        raise AssertionError(f"non-finite y_val {y_val}")
    if not (np.isin(y, (0, 1)).all() and (y_val >= 0).all() and (y_val <= 1).all()):
        raise AssertionError(f"verdicts out of range: y={y} y_val={y_val}")


def make_plan(pallas: str, int8_mlp: str, int8_heads: bool):
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

    return KernelPlan(pallas=pallas, int8_mlp=int8_mlp, int8_heads=int8_heads)


def expected_launches(kcuda, pallas: str, int8_mlp: str, int8_heads: bool,
                       tails: int = 54, chains: int = K6_PER_FORWARD) -> dict:
    """Every kernel's launches in one ensemble forward of a configuration
    (tails: block tails per forward, 54 for convnext_tiny; chains: K6's
    launches under pallas='stage', 5 for convnext_tiny)."""
    want = dict.fromkeys(kcuda.launch_counts(), 0)
    if pallas == "1":
        want["fused_convnext_block"] = K5_PER_FORWARD
    elif pallas == "stage":
        want["fused_convnext_stage"] = chains
    else:
        want["layer_norm_rows"] = 3
        want["ln_mlp_residual_int8" if int8_mlp else "ln_mlp_residual"] = tails
    want["matmul_wint8"] = int(int8_heads)
    return want


def backbone_config(backbone: str):
    from genconvit_tpu_torch.config import Config, ModelConfig

    return Config(model=ModelConfig(backbone=backbone))


def phase_slice(torch, np, dev, card: str, cfg, backbone: str = "convnext_tiny",
                tails: int = 54, chains: int = K6_PER_FORWARD) -> tuple:
    """The slice's requests through one Predictor of configuration cfg;
    every forward must launch exactly the kernels of its plan."""
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops import cuda as kcuda

    name, pallas, int8_mlp, int8_heads = cfg
    want = expected_launches(kcuda, pallas, int8_mlp, int8_heads, tails, chains)
    t0 = time.perf_counter()
    pred = Predictor(backbone_config(backbone), net="genconvit", device=dev, seed=0,
                     kernel_plan=make_plan(pallas, int8_mlp, int8_heads))
    torch.cuda.synchronize()
    log(f"slice [{name}]: Predictor (random init on device, bf16, "
        f"{'int8 heads, ' if int8_heads else ''}{'packs' if pallas else 'folds'}) {time.perf_counter() - t0:.2f} s; "
        f"plan {pred.kernel_plan}; weights {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats(dev)
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
    kcuda.reset_launch_counts()
    for rname, v, fn in requests:
        before = kcuda.launch_counts()
        t = time.perf_counter()
        y, y_val = fn()
        dt = time.perf_counter() - t
        after = kcuda.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        log(f"slice [{name}] {rname}: y={y.tolist()} y_val={np.round(y_val, 5).tolist()} "
            f"({dt:.2f} s, launches {got})")
        check_verdicts(np, np.asarray(y), np.asarray(y_val, np.float64), v)
        if got != want:
            raise AssertionError(f"[{name}] {rname}: kernel launches {got}, want {want}")
    totals = kcuda.launch_counts()
    empty = pred.predict_faces(np.zeros((0, IMG, IMG, 3), np.uint8), FRAMES)
    if empty != (0, 0.5) or kcuda.launch_counts() != totals:
        raise AssertionError(f"zero faces gave {empty}, launches {kcuda.launch_counts()}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"slice [{name}]: zero faces -> {empty}; main-path launches {totals} over "
        f"{len(requests)} forwards; peak device memory over the forwards {peak:.2f} GiB [{card}]")
    return pred, totals, peak


def phase_parity(torch, np, dev, card: str, configs=CONFIGS,
                 backbone: str = "convnext_tiny") -> dict:
    """Each configuration vs the float32 plain path on the same weights."""
    from genconvit_tpu_torch.infer.aggregate import masked_prob_sums
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.models.convnext import Block

    config = backbone_config(backbone)
    base = Predictor(config, net="genconvit", device=dev, seed=1, dtype=torch.float32,
                     deterministic_vae=True, kernel_plan=make_plan("", "", False))
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
    params = base.state_dicts()
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

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m32 = means(base)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del base
    torch.cuda.empty_cache()
    y32, v32 = verdicts(m32)
    log(f"parity [{backbone}]: f32 plain class means {np.round(m32, 5).tolist()}")
    out = {}
    for name, pallas, int8_mlp, int8_heads in configs:
        p16 = Predictor(config, net="genconvit", device=dev, params=params,
                        deterministic_vae=True,
                        kernel_plan=make_plan(pallas, int8_mlp, int8_heads))
        m16 = means(p16)
        del p16
        torch.cuda.empty_cache()
        y16, v16 = verdicts(m16)
        tol = YVAL_TOL_INT8 if int8_mlp else YVAL_TOL
        dyv = float(np.abs(v16 - v32).max())
        decisive = np.abs(m32[:, 0] - m32[:, 1]) > 2 * tol
        log(f"parity [{name}, {backbone}] vs f32 plain: class means {np.round(m16, 5).tolist()}; "
            f"max|dy_val| = {dyv:.3e} (limit {tol}); decisive videos "
            f"{int(decisive.sum())}/{v}, y {y16.tolist()} f32 {y32.tolist()} [{card}]")
        if not dyv <= tol:
            raise AssertionError(f"[{name}] max|dy_val| {dyv} > {tol}")
        if not decisive.any():
            raise AssertionError(f"[{name}] no decisive video: the y check would test nothing")
        if not (y16[decisive] == y32[decisive]).all():
            raise AssertionError(f"[{name}] y differs on a decisive video")
        out[name] = dyv
    return out


def phase_large(torch, np, dev, card: str, profile: bool) -> dict:
    """Phase 10: convnext_large (the JAX package's `--s large` backbone) at
    full width and depth through the default plan, through int8 heads +
    int8_mlp='full' and through pallas='stage': the requests with 108 K1
    (or K4) and 3 K2 launches per forward (and K3's one), or 8 K6 launches,
    throughput, parity of each against one float32 plain path. Returns each
    configuration's record."""
    import gc

    out = {}
    for cfg in LARGE_CONFIGS:
        pred, totals, peak = phase_slice(torch, np, dev, card, cfg, LARGE, LARGE_K1_PER_FORWARD,
                                         LARGE_K6_PER_FORWARD)
        # V=1 is not timed under 'stage' (a third of a second a launch there)
        rates = phase_throughput(torch, pred, dev, card, f"{cfg[0]}, {LARGE}",
                                 v1=cfg[1] != "stage")
        if profile and cfg[0] == "default":
            phase_profile(torch, pred, dev, card, f"{cfg[0]}, {LARGE}")
        del pred
        gc.collect()
        torch.cuda.empty_cache()
        out[cfg[0]] = dict(rates, launches=totals, peak_forward_gib=peak)
    dyv = phase_parity(torch, np, dev, card, LARGE_CONFIGS, LARGE)
    for name, rec in out.items():
        rec["dy_val"] = dyv[name]
    return out


def phase_throughput(torch, pred, dev, card: str, name: str, v1: bool = True) -> dict:
    """videos/s at V=8 and, unless v1 is False, the V=1 latencies."""
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
            log(f"throughput [{name}] V={v}: {rates[-1][0]:.2f} videos/s, "
                f"{rates[-1][1]:.2f} ms/launch [{card}]")
        return bufs, mask, rates

    torch.cuda.reset_peak_memory_stats(dev)
    _, _, r8 = run(8, 6)
    best = max(r8)
    peak8 = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"throughput [{name}] V=8 best: {best[0]:.2f} videos/s, {best[1]:.2f} ms/launch; "
        f"peak device memory {peak8:.2f} GiB [{card}]")
    if not v1:
        return {"v8_videos_s": best[0], "v8_ms": best[1], "v1_ms": None,
                "v1_sync_median_ms": None, "peak_v8_gib": peak8}
    bufs, mask, r1 = run(1, 24)
    lat = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, y_val = pred.forward_batched(bufs[i % 4], mask)
        y_val.cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    v1 = min(r[1] for r in r1)
    log(f"latency [{name}] V=1: pipelined best {v1:.2f} ms/launch; synchronized "
        f"call median {lat[len(lat) // 2]:.2f} ms, min {lat[0]:.2f} ms [{card}]")
    return {"v8_videos_s": best[0], "v8_ms": best[1], "v1_ms": v1,
            "v1_sync_median_ms": lat[len(lat) // 2], "peak_v8_gib": peak8}


def convnext_group(key: str) -> str:
    """The scoring path's kernel groups of the profile."""
    k = key.lower()
    if "fused_wgmma" in k:   # one kernel template, K5's GELU form or K6's
        return "K5 fused_block" if "geluhp<0>" in k else "K6 fused_stage"
    if "ln_mlp_residual_int8" in k:
        return f"K4 {key}"
    if "wint8" in k:
        return "K3 matmul_wint8 (split-K product, epilogue)"
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


def swin_group(key: str) -> str:
    """The Swin forward's kernel groups of the profile."""
    k = key.lower()
    if "window_attn" in k:
        return "K7 window_attention"
    if any(s in k for s in ("fprop", "conv", "implicit", "cudnn")):
        return "patch-embed convolution (cuDNN)"
    if any(s in k for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "GEMMs (qkv, proj, fc1, fc2, reductions, head)"
    if "roll" in k or "copy" in k:
        return "copies (roll, window permutes, cat, dtype casts)"
    return "LayerNorm and elementwise (LN statistics, GELU, residuals, bias gather)"


def profile_step(torch, step, group, title: str, card: str, n: int = 3) -> None:
    """torch.profiler over n calls of step(i) after 3 warm-up calls: device
    time per call by group(kernel name), and the device's busy share of the
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    events = prof.key_averages()

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        return us / n / 1e3

    groups: dict = {}
    for e in events:  # device kernels, not the aten ops that launch them, nor the
        # profiler's "Command Buffer Full" markers (launch back-pressure)
        if dev_ms(e) > 0 and not e.key.startswith("aten::") and e.key != "Command Buffer Full":
            groups.setdefault(group(e.key), []).append((dev_ms(e), e.count // n, e.key))
    busy = sum(t for members in groups.values() for t, _, _ in members)
    if busy <= 0:
        raise AssertionError("profiler recorded no device time")
    log(f"profile {title}: {wall:.2f} ms/launch under the profiler, device "
        f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%) [{card}]")
    for name, members in sorted(groups.items(), key=lambda kv: -sum(m[0] for m in kv[1])):
        t = sum(m[0] for m in members)
        log(f"  {t:9.3f} ms {100 * t / busy:5.1f}%  {sum(m[1] for m in members):4d} "
            f"launches  {name}")
    for name in ("elementwise and other", "other convolutions (cuDNN)", swin_group("")):
        for t, count, key in sorted(groups.get(name, []), reverse=True)[:4]:
            log(f"    of which {t:7.3f} ms {count:4d} launches  {key[:110]}")


def phase_profile(torch, pred, dev, card: str, name: str) -> None:
    g = torch.Generator(device=dev).manual_seed(5)
    bufs = [torch.randint(0, 256, (8, FRAMES, IMG, IMG, 3), dtype=torch.uint8,
                          device=dev, generator=g) for _ in range(2)]
    mask = torch.ones(8, FRAMES, device=dev)
    profile_step(torch, lambda i: pred.forward_batched(bufs[i % 2], mask), convnext_group,
                 f"[{name}] V=8 forward", card)


def phase_swin(torch, dev, card: str, profile: bool) -> dict:
    """The Swin slice (phase 8): swin_tiny through its three entry points at
    N=120 and 15 in bf16, with K7 and with pallas='0', against the float32
    plain path on the same weights; throughput and peak memory."""
    import copy

    from genconvit_tpu_torch.models.hybrid_embed import HybridEmbed
    from genconvit_tpu_torch.models.init import init_hybrid_embed_
    from genconvit_tpu_torch.models.swin import SWIN_CFGS, WindowAttention
    from genconvit_tpu_torch.ops import cuda as kcuda
    from genconvit_tpu_torch.ops.cuda import window_attn as k7
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

    g = torch.Generator(device=dev).manual_seed(13)
    cfg = SWIN_CFGS[SWIN_TINY]
    width = cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)   # 768: the token width
    hyb32 = HybridEmbed(SWIN_TINY, embed_dim=width, feature_dim=width).to(dev)
    init_hybrid_embed_(hyb32, g)
    with torch.no_grad():   # O(1) bias tables: the 0.02 init would make the bias path vacuous
        for mod in hyb32.modules():
            if isinstance(mod, WindowAttention):
                mod.relative_position_bias_table.normal_(0.0, 1.0, generator=g)
    hyb = copy.deepcopy(hyb32).to(torch.bfloat16).eval()
    n_max = max(SWIN_BATCHES)
    x32 = torch.randn(n_max, 3, IMG, IMG, device=dev, generator=g).contiguous(
        memory_format=torch.channels_last)
    x16 = x32.to(torch.bfloat16)
    entries = {"features": lambda m, x, p: m.backbone.features(x, p),
               "logits": lambda m, x, p: m.backbone(x, p),
               "tokens": lambda m, x, p: m.tokens(x, p)}
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = {name: fn(hyb32, x32, KernelPlan()) for name, fn in entries.items()}
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del hyb32
    torch.cuda.empty_cache()

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    plans = (("K7", KernelPlan()), ("pallas=0", KernelPlan(pallas="0")))
    outs, main_counts = {}, None
    kcuda.reset_launch_counts()   # the main path (K7) starts from 0
    for pname, plan in plans:
        want = K7_PER_FORWARD if pname == "K7" else (0, 0)
        for n in SWIN_BATCHES:
            for name, fn in entries.items():
                before = (k7.window_attention.launches, k7.window_attention.masked_launches)
                with torch.inference_mode():
                    y = fn(hyb, x16[:n], plan)
                torch.cuda.synchronize()
                got = (k7.window_attention.launches - before[0],
                       k7.window_attention.masked_launches - before[1])
                r = ref[name][:n]
                d = rel(y, r)
                log(f"swin [{pname}] N={n} {name} {tuple(y.shape)}: max|diff|/max|ref| vs f32 "
                    f"plain {d:.3e} (limit {REL_TOL}); K7 launches {got[0]}, {got[1]} with a "
                    f"mask [{card}]")
                if y.shape != r.shape or not torch.isfinite(y).all():
                    raise AssertionError(f"swin [{pname}] N={n} {name}: shape {tuple(y.shape)} "
                                         f"or non-finite values")
                if got != want:
                    raise AssertionError(f"swin [{pname}] N={n} {name}: K7 launches {got}, "
                                         f"want {want}")
                if not d <= REL_TOL:
                    raise AssertionError(f"swin [{pname}] N={n} {name}: {d} > {REL_TOL}")
                outs[(pname, n, name)] = y
        if pname == "K7":
            main_counts = kcuda.launch_counts()
            others = {k: v for k, v in main_counts.items() if k != "window_attention" and v}
            if others:
                raise AssertionError(f"swin launched other kernels: {others}")
    for n in SWIN_BATCHES:
        for name in entries:
            d = rel(outs[("K7", n, name)], outs[("pallas=0", n, name)])
            log(f"swin N={n} {name}: K7 vs pallas=0 (both bf16) max|diff|/max|ref| {d:.3e} "
                f"(limit {REL_TOL}) [{card}]")
            if not d <= REL_TOL:
                raise AssertionError(f"swin N={n} {name}: K7 vs pallas=0 {d} > {REL_TOL}")
    del outs, ref

    rates = {}
    for pname, plan in plans:
        for n in SWIN_BATCHES:
            bufs = [torch.randn(n, 3, IMG, IMG, device=dev, generator=g).to(torch.bfloat16)
                    .contiguous(memory_format=torch.channels_last) for _ in range(4)]
            iters = 6 if n > 30 else 12
            torch.cuda.reset_peak_memory_stats(dev)
            with torch.inference_mode():
                for i in range(2):
                    hyb.backbone(bufs[i], plan)
                torch.cuda.synchronize()
                best = None
                for _ in range(3):
                    t0 = time.perf_counter()
                    for i in range(iters):
                        hyb.backbone(bufs[i % 4], plan)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) / iters * 1e3
                    best = ms if best is None else min(best, ms)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            rates[(pname, n)] = (n / best * 1e3, best, peak)
            log(f"swin throughput [{pname}] N={n}: {n / best * 1e3:.2f} images/s, {best:.3f} "
                f"ms/forward (best of 3 trials of {iters}); peak device memory {peak:.2f} GiB "
                f"[{card}]")
            del bufs
    if profile:
        pbufs = [torch.randn(n_max, 3, IMG, IMG, device=dev, generator=g).to(torch.bfloat16)
                 .contiguous(memory_format=torch.channels_last) for _ in range(2)]
        with torch.inference_mode():
            profile_step(torch, lambda i: hyb.backbone(pbufs[i % 2], KernelPlan()), swin_group,
                         f"[swin K7] N={n_max} forward", card)
    return {"launches": main_counts, "rates": rates}


def folded_shapes() -> list:
    """(call, n, H, C, blocks per forward) of the LN-folded bf16 blocks
    under pallas='1': the blocks K5's rule leaves out (M3's card shapes)."""
    from genconvit_tpu_torch.models.convnext import block_kernel_applies

    return [(call, n, (px // 4) >> si, c, DEPTHS[si]) for call, n, px in CALLS
            for si, c in enumerate(DIMS) if not block_kernel_applies((px // 4) >> si)]


SASS_MMA = ("HGMMA", "IGMMA", "HMMA", "IMMA")   # warpgroup MMA (bf16, s8), then mma.sync's


def sass_mma_counts(path: str) -> dict:
    """{M1 instantiation (int8, NC): {opcode: count}} of the tensor-core
    instructions in the built library's SASS (cuobjdump), for
    check_m1_sass."""
    import os
    import re

    from genconvit_tpu_torch.ops.cuda._build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"dots_kernelILb([01])ELi(\d+)E", line)
            fn = (m.group(1) == "1", int(m.group(2))) if m else None
            if fn is not None:
                counts[fn] = dict.fromkeys(SASS_MMA, 0)
        elif fn is not None:
            op = re.search(r"\b(HGMMA|IGMMA|HMMA|IMMA)\b", line)
            if op:
                counts[fn][op.group(1)] += 1
    return counts


def check_m1_sass(counts: dict) -> None:
    """Every M1 instantiation on warpgroup MMA alone (HGMMA for bf16, IGMMA
    for int8; no mma.sync), with at least the wgmma of its three loops (the
    sink blocks of z past c, the group's z, o): NC / 64 boxes x 4 k steps
    each, so a dropped sink loop shows."""
    if not counts:
        log("M1 SASS: cuobjdump not found; not checked")
        return
    for int8, nc in [(False, 64), (False, 128), (True, 64), (True, 128)]:
        got = counts.get((int8, nc))
        want = "IGMMA" if int8 else "HGMMA"
        log(f"M1 SASS dots_kernel<{'int8' if int8 else 'bf16'}, NC={nc}>: {got}")
        if got is None or got[want] < 3 * (nc // 64) * 4 or got["HMMA"] or got["IMMA"] \
                or got["IGMMA" if want == "HGMMA" else "HGMMA"]:
            raise AssertionError(f"M1's SASS at (int8={int8}, NC={nc}): {got}; want only "
                                 f"{want}, at least {3 * (nc // 64) * 4}")


def probe_m1(torch, dev, card: str, g) -> list:
    """M1 in both variants at the JAX tool's default shape, K4's 12
    block-tail shapes and, at the ED call's rows, convnext_large's four
    stage widths and convnext_base's last (K1_WIDE, as phase 3's K1 and
    K4; not in the per-forward sums)."""
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
    from genconvit_tpu_torch.ops.cuda import int8_dot as m1
    from genconvit_tpu_torch.tools.microbench_int8_dot import dots_bound, make_inputs

    n, h, c = M1_TOOL_SHAPE
    shapes = [(f"the JAX tool's default {n} x {h}^2", n * h * h, c, 3 * c, 0)]
    for call, n, px in CALLS:
        for si, c in enumerate(DIMS):
            h = (px // 4) >> si
            shapes.append((f"K4 {call} s{si}", n * h * h, c, 4 * c, DEPTHS[si]))
    n, px = CALLS[0][1:]
    for name, si, c in K1_WIDE:
        h = (px // 4) >> si
        shapes.append((f"{name} ed s{si}", n * h * h, c, 4 * c, 0))
    recs = []
    for kind in ("bf16", "int8"):
        fn, plain, tol = ((m1.dots_bf16, m1.dots_bf16_plain, m1.ULP_TOL) if kind == "bf16"
                          else (m1.dots_int8, m1.dots_int8_plain, m1.ULP_TOL_INT8))
        rec = {"err": 0.0, "ulps": 0.0, "planted_min": float("inf"), "ms": 0.0, "plain_ms": 0.0,
               "lib_ms": 0.0, "bound_ms": 0.0, "sides": []}
        for tag, rows, c, hid, depth in shapes:
            ops = list(make_inputs(kind, rows, c, hid, dev, g))
            if kind == "int8":   # scales off 1: a scale on the wrong column must show
                ops[3] = torch.rand(hid, device=dev, generator=g) + 0.5
                ops[5] = torch.rand(c, device=dev, generator=g) + 0.5
            what = f"M1 {kind} {tag:36s} R={rows:6d} C={c:4d} hid={hid:4d} {m1.m1_plan(c, hid)}"
            ref = plain(*ops)
            err, rel, ulps = compare(torch, km, what, fn(*ops), ref, tol=tol)
            rec["err"], rec["ulps"] = max(rec["err"], err), max(rec["ulps"], ulps)
            log(f"{what} max|diff|={err:.3e} rel={rel:.3e} ulps={ulps:g} (limit {tol:g})")
            s1, w2 = (ops[3], ops[4]) if kind == "int8" else (None, ops[3])
            for name, (b1, bs1, b2) in m1.planted_faults(kind, ops[2], s1, w2).items():
                bad = fn(*ops[:2], *([b1, bs1, b2, ops[5]] if kind == "int8" else [b1, b2]))
                rec["planted_min"] = min(rec["planted_min"], m1.ulp_error(bad, ref))
                log(f"  M1 {kind} planted: " + must_fail(torch, km, name, bad, ref, tol=tol))
            del ref, bad
            if kind == "bf16":
                y, hh, w1, w2 = ops

                def lib():
                    z = torch.matmul(y, w1.t())
                    return torch.matmul(hh, w2.t()) + z[:, :c]
            else:
                yq, hq, w1q, s1, w2q, s2 = ops

                def lib():
                    z = torch._int_mm(yq, w1q.t())
                    o = torch._int_mm(hq, w2q.t())
                    return (o.float() * s2 + z[:, :c].float() * s1[:c]).to(torch.bfloat16)
            iters = 20 if rows * hid < 5e7 else 10
            t_k = cuda_ms(torch, lambda: fn(*ops), iters)
            t_p = cuda_ms(torch, lambda: plain(*ops), 1, 1)
            t_l = cuda_ms(torch, lib, iters)
            bd, by = dots_bound(kind, rows, c, hid)
            log(f"M1 time {kind} {tag} R={rows} C={c} hid={hid}: kernel {t_k:.4f} ms, plain "
                f"{t_p:.4f} ms, library ({'2 matmul + add' if kind == 'bf16' else '2 _int_mm + scales'}) "
                f"{t_l:.4f} ms, bound {bd:.4f} ms ({by}); x{depth} per forward [{card}]")
            for key, t in (("ms", t_k), ("plain_ms", t_p), ("lib_ms", t_l), ("bound_ms", bd)):
                rec[key] += depth * t
            if depth:
                rec["sides"].append((depth * bd, by))
            del ops
        log(f"M1 {kind} per V=8 forward at K4's shapes (54 block tails, depth-weighted): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library {rec['lib_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({side(rec['sides'])}); max ulps {rec['ulps']:g}; "
            f"planted faults >= {rec['planted_min']:.1f} ulps [{card}]")
        recs.append({"name": f"dots_{kind}", "route": "cuda",
                     "source": "genconvit_tpu_torch/csrc/int8_dot.cu",
                     "replaces": f"tools/microbench_int8_dot.py:{51 if kind == 'bf16' else 58}",
                     "launches": 0, "max_abs_err": rec["err"], "ms": rec["ms"],
                     "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                     "bound_by": side(rec["sides"]), "library_ms": rec["lib_ms"]})
    return recs


def parts_bound(phase: str, rows: int, c: int) -> tuple:
    """Bound of one M2 launch cut after `phase`: x in and the output out
    once (bf16) and the weights the phase reads once; on the f32 cores the
    taps (98*R*C), the LayerNorm (~8*R*C) and the GELU (~25 operations an
    element of the [R, 4C] hidden), beside the tensor cores' fc1 and fc2
    (8*R*C^2 each)."""
    from genconvit_tpu_torch.ops.cuda.block_parts import PHASES

    k = PHASES.index(phase)
    nbytes = 2 * rows * c * 2 + (49 * c * 2 + 4 * c if k >= 1 else 0) \
        + (8 * c if k >= 3 else 0) + (8 * c * c + 16 * c if k >= 4 else 0) \
        + (8 * c * c + 8 * c if k >= 6 else 0)
    f32 = (98 * rows * c if k >= 1 else 0) + (8 * rows * c if k >= 3 else 0) \
        + (25 * rows * 4 * c if k >= 5 else 0)
    tc = (8 * rows * c * c if k >= 4 else 0) + (8 * rows * c * c if k >= 6 else 0)
    return bound(nbytes, {BF16: tc}, {FP32: f32})


def probe_m2(torch, dev, card: str, g) -> dict:
    """M2 at its 7 phases at K5's 5 path shapes, with the per-phase deltas."""
    from genconvit_tpu_torch.models.convnext import _nhwc
    from genconvit_tpu_torch.ops.cuda import block_parts as m2
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km

    k5_shapes, _ = fused_shapes()
    rec = {"err": 0.0, "ulps": 0.0, "planted_min": float("inf"), "ms": 0.0, "plain_ms": 0.0,
           "lib_ms": 0.0, "bound_ms": 0.0, "sides": []}
    # and convnext_base's and convnext_large's last stages at the ED call's
    # rows (not in the per-forward sums)
    for call, n, h, c, depth in k5_shapes + list(M2_WIDE):
        blk = random_fused_block(torch, c, dev, g)
        x = torch.randn(n, h, h, c, device=dev, generator=g).to(torch.bfloat16)
        with torch.inference_mode():
            p = blk.pack_fused()
            times = {}
            for phase in m2.PHASES:
                what = f"M2 {call:8s} N={n} H={h:2d} C={c:3d} {phase:10s}"
                ref = m2.block_parts_plain(x, p, phase)
                floor = m2.ulp_floor(ref, x, phase)
                err, rel, ulps = compare(torch, km, what, m2.block_parts(x, p, phase), ref,
                                         *floor, m2.ULP_TOL)
                rec["err"], rec["ulps"] = max(rec["err"], err), max(rec["ulps"], ulps)
                log(f"{what} max|diff|={err:.3e} rel={rel:.3e} ulps={ulps:g}")
                for name, bad in m2.planted_faults(p, phase).items():
                    out = m2.block_parts(x, bad, phase)
                    rec["planted_min"] = min(rec["planted_min"], m2.ulp_error(out, ref, x, phase))
                    log(f"  M2 {phase} planted: "
                        + must_fail(torch, km, name, out, ref, *floor, m2.ULP_TOL))
                del ref
                iters = 10 if n * h * h * c < 5e7 else 5
                t_k = cuda_ms(torch, lambda: m2.block_parts(x, p, phase), iters)
                t_p = cuda_ms(torch, lambda: m2.block_parts_plain(x, p, phase), 1, 1)
                times[phase] = (t_k, t_p)
            xc = x.permute(0, 3, 1, 2)   # the NCHW channels_last view
            folded = blk.fold()
            t_dw = cuda_ms(torch, lambda: blk.dw(xc), 10)
            t_full = cuda_ms(torch, lambda: km.ln_mlp_residual(_nhwc(blk.dw(xc)), x, folded), 10)
        prev = 0.0
        for phase in m2.PHASES:
            t_k, t_p = times[phase]
            bd, by = parts_bound(phase, n * h * h, c)
            delta = "" if phase == "dw_bf16acc" else f" (+{t_k - prev:.4f})"
            lib = {"dw": f", cuDNN dw {t_dw:.4f} ms", "full": f", cuDNN dw + K1 {t_full:.4f} ms"}
            log(f"M2 time {call:8s} N={n} H={h:2d} C={c:3d} {phase:10s}: kernel {t_k:.4f} ms"
                f"{delta}, plain {t_p:.4f} ms{lib.get(phase, '')}, bound {bd:.4f} ms ({by}) "
                f"[{card}]")
            if phase != "dw_bf16acc":
                prev = t_k
        bd, by = fused_bound(n * h * h, c, 1)
        for key, t in (("ms", times["full"][0]), ("plain_ms", times["full"][1]),
                       ("lib_ms", t_full), ("bound_ms", bd)):
            rec[key] += depth * t
        if depth:
            rec["sides"].append((depth * bd, by))
        del blk, x, p, folded
    log(f"M2 'full' per V=8 forward at K5's shapes ({K5_PER_FORWARD} launches): kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, cuDNN dw + K1 {rec['lib_ms']:.4f} "
        f"ms, bound {rec['bound_ms']:.4f} ms ({side(rec['sides'])}); max ulps {rec['ulps']:g}; "
        f"planted faults >= {rec['planted_min']:.1f} ulps [{card}]")
    return {"name": "block_parts", "route": "cuda",
            "source": "genconvit_tpu_torch/csrc/block_parts.cu",
            "replaces": "tools/microbench_kernel_parts.py:44", "launches": 0,
            "max_abs_err": rec["err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": side(rec["sides"]),
            "library_ms": rec["lib_ms"]}


def probe_m3(torch, dev, card: str, g) -> dict:
    """M3 at the JAX tool's default shape, the 7 LN-folded block shapes
    under pallas='1' and M3_WIDE: against the plain version, the same bits
    from two launches, its planted faults refused, timed beside cuDNN dw + 2
    reductions and the bound (the taps inside the image only)."""
    from genconvit_tpu_torch.ops.cuda import dw_moments as m3
    from genconvit_tpu_torch.tools._timing import FP32, bound_ms
    from genconvit_tpu_torch.tools.microbench_dwshift import dw_bound, make_inputs

    def same_bits(a, b):
        return all(torch.equal(u.view(torch.int16 if u.dtype == torch.bfloat16 else torch.int32),
                               v.view(torch.int16 if v.dtype == torch.bfloat16 else torch.int32))
                   for u, v in zip(a, b))

    shapes = [("tool",) + M3_TOOL_SHAPE + (0,)] + folded_shapes() + list(M3_WIDE)
    rec = {"err": 0.0, "worst": {}, "planted": [], "ms": 0.0, "plain_ms": 0.0, "lib_ms": 0.0,
           "bound_ms": 0.0, "sides": []}
    for call, n, h, c, depth in shapes:
        x, k, b = make_inputs(n, h, c, dev, g)
        what = f"M3 {call:8s} N={n} H={h:2d} C={c:3d}"
        ref = m3.dw_moments_plain(x, k, b)
        out = m3.dw_moments(x, k, b)
        torch.cuda.synchronize()
        err = m3.ulp_error(out, ref)
        dw_abs = (out[0].float() - ref[0].float()).abs().max().item()
        rel = dw_abs / ref[0].float().abs().max().item()
        finite = all(torch.isfinite(t).all() for t in out)
        if not (finite and rel <= REL_TOL and m3.agrees(err)):
            raise AssertionError(f"{what}: {err}, dw /max|ref| {rel:.3e} (limits "
                                 f"{m3.ULP_TOL} ulps, {m3.MOMENT_TOL}, {REL_TOL})")
        rec["err"] = max(rec["err"], dw_abs)
        for key, v in err.items():
            rec["worst"][key] = max(rec["worst"].get(key, 0.0), v)
        if not same_bits(out, m3.dw_moments(x, k, b)):
            raise AssertionError(f"{what}: two launches gave different bits")
        gap = m3.moments_rounding_gap(*out)
        log(f"{what} dw max|diff|={dw_abs:.3e} rel={rel:.3e} ulps={err['dw_ulps']:g}; mean "
            f"{err['mean_rel']:.2e}, var {err['var_rel']:.2e} (limit {m3.MOMENT_TOL:g}); moments "
            f"of the rounded dw (the yardstick's) vs the f32 sums': mean {gap[0]:.2e}, var "
            f"{gap[1]:.2e}; two launches: the same bits")
        faults = {name: m3.dw_moments(x, *args) for name, args in m3.planted_faults(k, b).items()}
        faults["var without - mean^2"] = (out[0], out[1], m3.var_without_mean_sq(out[1], out[2]))
        faults["halo from the image before"] = m3.dw_moments(m3.halo_from_neighbour(x), k, b)
        faults["last slice out of the moments"] = m3.moments_without_last_slice(x, k, b)
        for name, bad in faults.items():
            e = m3.ulp_error(bad, ref)
            if m3.agrees(e):
                raise AssertionError(f"planted fault {name} passed the check ({e})")
            rec["planted"].append(max(e["dw_ulps"] / m3.ULP_TOL, e["mean_rel"] / m3.MOMENT_TOL,
                                      e["var_rel"] / m3.MOMENT_TOL))
            log(f"  M3 planted: {name}: dw {e['dw_ulps']:.1f} ulps, mean {e['mean_rel']:.2e}, "
                f"var {e['var_rel']:.2e} -> refused")
        del out, ref, faults
        iters = max(10, min(200, int(2e8 // (n * h * h * c))))   # the small shapes' noise
        t_k = cuda_ms(torch, lambda: m3.dw_moments(x, k, b), iters)
        t_p = cuda_ms(torch, lambda: m3.dw_moments_plain(x, k, b), 1, 1)
        t_l = cuda_ms(torch, lambda: m3.dw_moments_library(x, k, b), iters)
        bd, by = dw_bound(n, h, h, c)
        px = n * h * h
        every_tap = bound_ms(px * c * 4 + px * 8 + 200 * c, {FP32: 98 * px * c})[0]
        log(f"M3 time {call:8s} N={n} H={h:2d} C={c:3d}: kernel {t_k:.4f} ms, plain {t_p:.4f} "
            f"ms, cuDNN dw + 2 reductions {t_l:.4f} ms, bound {bd:.4f} ms ({by}; the taps inside "
            f"the image; all 49 taps counted {every_tap:.4f} ms); x{depth} per forward [{card}]")
        rec["ms"] += depth * t_k
        rec["plain_ms"] += depth * t_p
        rec["lib_ms"] += depth * t_l
        rec["bound_ms"] += depth * bd
        if depth:
            rec["sides"].append((depth * bd, by))
        del x, k, b
    w = rec["worst"]
    log(f"M3 per V=8 forward at the LN-folded blocks of pallas='1' (39 blocks): kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, cuDNN dw + 2 reductions "
        f"{rec['lib_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({side(rec['sides'])}); worst dw "
        f"{w['dw_ulps']:g} ulps, mean {w['mean_rel']:.2e}, var {w['var_rel']:.2e}; planted faults "
        f">= {min(rec['planted']):.1f}x their limit [{card}]")
    return {"name": "dw_moments", "route": "cuda", "source": "genconvit_tpu_torch/csrc/dw_moments.cu",
            "replaces": "tools/microbench_dwshift.py:70", "launches": 0,
            "max_abs_err": rec["err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": side(rec["sides"]),
            "library_ms": rec["lib_ms"]}


def phase_probes(torch, dev, card: str, lib_path: str) -> tuple:
    """Phase 9: M1-M3 against their plain versions and timed at their card
    shapes; then the three tools at their defaults, with every count at 0
    before, whose launches are the probes' main-path counts."""
    import contextlib
    import io

    from genconvit_tpu_torch.ops import cuda as kcuda
    from genconvit_tpu_torch.tools import (microbench_dwshift, microbench_int8_dot,
                                           microbench_kernel_parts)

    check_m1_sass(sass_mma_counts(lib_path))
    g = torch.Generator(device=dev).manual_seed(5678)
    recs = probe_m1(torch, dev, card, g) + [probe_m2(torch, dev, card, g),
                                            probe_m3(torch, dev, card, g)]
    torch.cuda.empty_cache()
    kcuda.reset_launch_counts()
    for tool, argv in ((microbench_int8_dot, ["--trials", "3"]),
                       (microbench_kernel_parts, ["--iters", "2"]),
                       (microbench_dwshift, ["--iters", "3"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(argv)
        for line in buf.getvalue().splitlines():
            log(f"  {tool.__name__.rsplit('.', 1)[1]}: {line}")
        if rc != 0:
            raise AssertionError(f"{tool.__name__} exited {rc}")
    got = kcuda.launch_counts()
    probes = ("dots_bf16", "dots_int8", "block_parts", "dw_moments")
    others = {k: v for k, v in got.items() if k not in probes and v}
    if others or not all(got[k] > 0 for k in probes):
        raise AssertionError(f"the tools launched {got}: every probe, and nothing else")
    log(f"phase 9 tools: launches {({k: got[k] for k in probes})}")
    return recs, got


VIDEO_SIZES = ((1080, 1920), (720, 1280), (360, 640), (256, 256))   # two videos each
VIDEO_BATCH = 8
DET_WINDOWS = 512
DET_TOL = 1e-3       # detector logits and boxes, card vs CPU, float32
DET_BOX_PX = 2       # detect_many's corners, card vs CPU (the CPU tests' bound vs JAX)
RECORDED_TOL = 2e-3  # predict_files vs predict_faces on the same crops: the same bf16
                     # path, only the batch differs (5.217e-04 in every run so far)
TIMED_COPIES = 8     # the timed run scores the eight face videos this many times
TIMED_RUNS = 3
DET_THRESH = 0.3     # the device detector's score threshold
NMS_MARGIN = 1e-2    # post-NMS slots compared where |score - DET_THRESH| > this


def draw_faces(np, rng, n: int, h: int, w: int):
    """n frames [n,h,w,3] uint8: a blocky background with a fixed noise
    pattern, and a drawn face (skin ellipse, eyes, brows, nose, mouth) that
    drifts from frame to frame."""
    bg = rng.integers(50, 130, (h // 90 + 1, w // 90 + 1, 3)).astype(np.uint8)
    img = np.repeat(np.repeat(bg, 90, 0), 90, 1)[:h, :w].copy()
    yy, xx = np.ogrid[:h, :w]
    s = min(h, w) * rng.uniform(0.35, 0.55)
    cy, cx = h / 2, w / 2 + rng.uniform(-0.1, 0.1) * w

    def ell(y, x, ry, rx, color):
        img[((yy - y) / ry) ** 2 + ((xx - x) / rx) ** 2 < 1] = color

    ell(cy, cx, 0.55 * s, 0.42 * s, (200, 160, 140))
    for dx in (-0.17 * s, 0.17 * s):
        ell(cy - 0.12 * s, cx + dx, 0.05 * s, 0.09 * s, (40, 30, 30))
        ell(cy - 0.22 * s, cx + dx, 0.015 * s, 0.1 * s, (60, 40, 30))
    ell(cy + 0.03 * s, cx, 0.09 * s, 0.02 * s, (150, 110, 100))
    ell(cy + 0.25 * s, cx, 0.05 * s, 0.15 * s, (120, 50, 50))
    img = np.clip(img.astype(np.int16) + rng.integers(-6, 7, img.shape, dtype=np.int16),
                  0, 255).astype(np.uint8)
    return np.stack([np.roll(img, (2 * i, 3 * i), (0, 1)) for i in range(n)])


def write_and_check(torch, what: str, path: str, branch: str, write, sd: dict) -> None:
    """Write one weight file, then read it back through `load_params`: every
    tensor equal to the written one. Size and seconds of both logged."""
    import os

    from genconvit_tpu_torch.core.checkpoint import load_params

    t = time.perf_counter()
    write(path)
    t_write = time.perf_counter() - t
    t = time.perf_counter()
    got, meta = load_params(path, branch)
    t_read = time.perf_counter() - t
    bad = [k for k in sd if k not in got or not torch.equal(got[k], sd[k])]
    if bad or set(got) != set(sd):
        raise AssertionError(f"{what}: load_params differs from the written tensors at "
                             f"{bad[:5]} (keys {len(got)} vs {len(sd)})")
    log(f"video [weights]: wrote {what} {os.path.getsize(path) / 2**20:.1f} MiB in "
        f"{t_write:.2f} s; load_params {t_read:.2f} s ({meta['source']}), {len(got)} tensors "
        f"equal to the written ones")


def video_weights(torch, dev, wdir: str) -> dict:
    """11a: seeded random ED and VAE weights (layer scale and heads as in
    phase 5, so that verdicts are decisive) written through the port's
    writers: the ED as a `.gcv` nested under 'ed' (train_model's layout),
    the VAE as a reference-keyed `.pth` nested under 'state_dict' with the
    dead groups added."""
    import os

    from genconvit_tpu_torch.core.checkpoint import MAX_CHUNK_SIZE, save_checkpoint
    from genconvit_tpu_torch.core.convert import tree_from_state_dict
    from genconvit_tpu_torch.models.convnext import Block
    from genconvit_tpu_torch.models.genconvit import GenConViT
    from genconvit_tpu_torch.models.init import init_genconvit_

    g = torch.Generator(device=dev).manual_seed(11)
    with torch.device("meta"):
        model = GenConViT(backbone_config("convnext_tiny"))
    model = model.to_empty(device=dev)
    init_genconvit_(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Block):
                m.gamma.uniform_(0.1, 1.0, generator=g)
        for branch in model.branches():
            branch.fc2.weight.mul_(LOGIT_SCALE)
            branch.fc2.bias.mul_(LOGIT_SCALE)
    sd = {b: {k: v.detach().cpu() for k, v in getattr(model, b).state_dict().items()}
          for b in ("ed", "vae")}
    del model
    torch.cuda.empty_cache()
    heads = sd["vae"]["encoder.mu.weight"]
    if not heads.element_size() * heads.nelement() > MAX_CHUNK_SIZE:
        raise AssertionError("the VAE head no longer exceeds the chunk size")
    dead = {"embedder.patch_embed.proj.weight": torch.randn(96, 3, 4, 4),
            "embedder.layers.0.blocks.0.attn.relative_position_index": torch.zeros(49, 49,
                                                                                   dtype=torch.long),
            "convnext_backbone.patch_embed.backbone.patch_embed.proj.weight": torch.randn(96, 3, 4, 4),
            "convnext_backbone.patch_embed.proj.weight": torch.randn(768, 1000, 1, 1),
            "encoder.fc1.weight": torch.randn(256, LATENT[0]), "encoder.fc1.bias": torch.randn(256),
            "encoder.fc2.weight": torch.randn(128, 256), "encoder.fc2.bias": torch.randn(128),
            "fc3.weight": torch.randn(500, 1000), "fc3.bias": torch.randn(500)}
    paths = {"ed": os.path.join(wdir, "genconvit_ed_inference.gcv"),
             "vae_pth": os.path.join(wdir, "vae_reference.pth"),
             "vae": os.path.join(wdir, "genconvit_vae_inference.gcv")}
    write_and_check(torch, "ed .gcv", paths["ed"], "ed", lambda p: save_checkpoint(
        p, {"ed": tree_from_state_dict(sd["ed"], "ed")}, epoch=1), sd["ed"])
    write_and_check(torch, "vae .pth", paths["vae_pth"], "vae", lambda p: torch.save(
        {"epoch": 1, "state_dict": dict(sd["vae"], **dead), "min_loss": 0.5}, p), sd["vae"])
    return {"sd": sd, "paths": paths}


def video_chunked_vae(torch, sd: dict, path: str) -> None:
    """11a, continued: the VAE as a `.gcv` nested under 'vae', whose two
    latent-head kernels (> 2^30 bytes each) must take flax's chunked form."""
    from genconvit_tpu_torch.core.checkpoint import (CHUNKED, _read_file, _unpack_all,
                                                     save_checkpoint)
    from genconvit_tpu_torch.core.convert import tree_from_state_dict

    write_and_check(torch, "vae .gcv", path, "vae", lambda p: save_checkpoint(
        p, {"vae": tree_from_state_dict(sd, "vae")}, epoch=1), sd)
    chunked = []

    def walk(node, where):
        if isinstance(node, dict):
            if CHUNKED in node:
                chunked.append(where)
            for k, v in node.items():
                walk(v, f"{where}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{where}/{i}")

    walk(_unpack_all(memoryview(_read_file(path))), "")
    want = ["/params/vae/encoder/mu/kernel", "/params/vae/encoder/var/kernel"]
    if sorted(chunked) != want:
        raise AssertionError(f"chunked arrays in the VAE .gcv: {chunked}, want {want}")
    log(f"video [weights]: the VAE .gcv holds its heads in flax's chunked form: {chunked}")


def check_loaded(torch, pred, sd: dict) -> None:
    """The Predictor's tensors are the written float32 ones cast to its
    dtype, bit for bit."""
    for branch, want in pred.state_dicts().items():
        for k, v in want.items():
            ref = sd[branch][k]
            ref = ref.to(v.dtype) if ref.is_floating_point() else ref
            if not torch.equal(v.cpu(), ref):
                raise AssertionError(f"Predictor {branch}.{k} differs from the written tensor")


def video_detector(torch, np, dev, card: str) -> None:
    """11b: the committed detector on the card against the same module on
    the CPU, with PyTorch's flags as a user has them (cuDNN's TF32 on by
    default: the detector turns it off for its own forward), on
    DET_WINDOWS seeded windows (half noise, half drawn faces); planted
    faults (the anchor offsets' scale dropped; the forward left in TF32)
    must fail, and the process-wide TF32 flag must be as it was."""
    from genconvit_tpu_torch.data.faces import DeviceFaceDetector, default_facedet_checkpoint
    from genconvit_tpu_torch.models import facedet

    rng = np.random.default_rng(21)
    wins = np.concatenate([rng.integers(0, 256, (DET_WINDOWS // 2, 128, 128, 3), dtype=np.uint8),
                           np.concatenate([draw_faces(np, rng, 1, 128, 128)
                                           for _ in range(DET_WINDOWS // 2)])])
    ckpt = default_facedet_checkpoint()
    cpu = DeviceFaceDetector(ckpt, device="cpu")
    gpu = DeviceFaceDetector(ckpt, device=dev)
    x = torch.from_numpy(wins)
    xg = x.to(dev)

    def run(det, xx):
        with torch.inference_mode():
            s, b = facedet.decode(det.model((xx.float() / 127.5 - 1.0).permute(0, 3, 1, 2)))
            ks, kb = facedet.detect_batch(det.model, xx, score_thresh=DET_THRESH)
        return [t.double().cpu().numpy() for t in (s, b, ks, kb)]

    def errs(a, b):
        return float(np.abs(a[0] - b[0]).max()), float(np.abs(a[1] - b[1]).max())

    def planted(name, value):
        keep = getattr(facedet, name)
        setattr(facedet, name, value)
        try:
            return run(gpu, xg)
        finally:
            setattr(facedet, name, keep)

    flag = torch.backends.cudnn.allow_tf32
    ref = run(cpu, x)
    got = run(gpu, xg)
    unscaled = planted("OFFSET_SCALE", 1.0)
    tf32 = planted("ALLOW_TF32", True)
    if torch.backends.cudnn.allow_tf32 != flag:
        raise AssertionError("the detector's forward left cuDNN's TF32 flag changed")
    es, eb = errs(got, ref)
    if not (es <= DET_TOL and eb <= DET_TOL):
        raise AssertionError(f"detector card vs CPU: scores {es:.3e}, boxes {eb:.3e} > {DET_TOL}")
    if not errs(unscaled, ref)[1] > DET_TOL:
        raise AssertionError("the planted fault (offsets unscaled) passed the detector check")
    if not max(errs(tf32, ref)) > DET_TOL:
        raise AssertionError("the planted fault (the forward in TF32) passed the detector check")
    ks, kb, rs, rb = got[2], got[3], ref[2], ref[3]
    clear = np.abs(rs - DET_THRESH) > NMS_MARGIN
    if not ((np.isfinite(ks) == np.isfinite(rs)) | ~clear).all():
        raise AssertionError("post-NMS kept slots differ between card and CPU")
    both = clear & np.isfinite(rs) & np.isfinite(ks)
    moved = np.abs(kb - rb).max(-1) > DET_TOL
    # a slot may pick another anchor only on a tie (scores within DET_TOL)
    ties = both & moved & (np.abs(np.subtract(ks, rs, out=np.zeros_like(ks), where=both))
                           <= DET_TOL)
    if (both & moved & ~ties).any():
        raise AssertionError("post-NMS boxes differ between card and CPU")
    t_ms = cuda_ms(torch, lambda: facedet.detect_batch(gpu.model, xg, score_thresh=DET_THRESH), 5)
    log(f"video [detector]: {DET_WINDOWS} windows, card vs CPU (cuDNN TF32 flag {flag}, the "
        f"forward's own off): max|d score| {es:.3e}, max|d box| {eb:.3e} (limit {DET_TOL}); "
        f"planted faults: the forward in TF32 {errs(tf32, ref)[0]:.3e} / {errs(tf32, ref)[1]:.3e}, "
        f"offsets unscaled {errs(unscaled, ref)[1]:.3e}; post-NMS slots kept "
        f"{int(np.isfinite(rs).sum())} of {rs.size}, {int(both.sum())} compared, {int(ties.sum())} "
        f"ties; detect_batch {t_ms:.3f} ms per {DET_WINDOWS} windows [{card}]")


def video_detect_many(torch, np, det, corpus: dict, card: str) -> None:
    """11b, continued: the file path's detector, `detect_many` on the card
    as `predict_files` runs it (windows cut on the card, the forward, boxes
    merged on the host), against the same detector on the CPU over the
    phase's corpus: the same box count in every frame and every corner
    within DET_BOX_PX."""
    from genconvit_tpu_torch.data.faces import DeviceFaceDetector, default_facedet_checkpoint

    cpu = DeviceFaceDetector(default_facedet_checkpoint(), device="cpu")
    names = sorted(corpus)
    frames = [corpus[n] for n in names]
    t = time.perf_counter()
    want = cpu.detect_many(frames)
    t_cpu = time.perf_counter() - t
    got = det.detect_many(frames)
    boxes, worst = 0, 0
    for n, gv, wv in zip(names, got, want):
        for fi, (gf, wf) in enumerate(zip(gv, wv)):
            if len(gf) != len(wf):
                raise AssertionError(f"detect_many {n} frame {fi}: card {gf}, CPU {wf}")
            for gb, wb in zip(gf, wf):
                worst = max(worst, max(abs(a - b) for a, b in zip(gb, wb)))
            boxes += len(wf)
    if worst > DET_BOX_PX or not boxes:
        raise AssertionError(f"detect_many card vs CPU: corners {worst} px (limit "
                             f"{DET_BOX_PX}) over {boxes} boxes")
    log(f"video [detector]: detect_many card vs CPU over the {len(names)} videos: the same box "
        f"count in all {sum(len(v) for v in want)} frames ({boxes} boxes), corners within "
        f"{worst} px (limit {DET_BOX_PX}); the CPU took {t_cpu:.1f} s [{card}]")


def video_crops(torch, np, dev, card: str) -> None:
    """11c: crop_faces on the card against the same function on the CPU, on
    boxes that up- and downscale, one axis of each, and touch the frame's
    edges: at most 1 LSB; a planted fault (cv2's coupled-axis fallback
    dropped) must fail."""
    from genconvit_tpu_torch.data import faces
    from genconvit_tpu_torch.ops import resize

    rng = np.random.default_rng(31)
    frames = draw_faces(np, rng, 3, 1080, 1920)
    q = IMG // 2
    boxes = [[(0, 1920, 1080, 0), (100, 250 + 3 * IMG, 100 + q, 250)],   # down; h up, w down
             [(900, 1920, 1080, 1800), (500, 1500, 1000, 700)],          # edge, up; down
             [(-20, 300, 200, -10), (300, 1000 + q, 300 + 3 * IMG, 1000)]]  # empty; h down, w up
    ref = faces.crop_faces(frames, boxes, 6, IMG, device="cpu").numpy().astype(np.int16)
    x = torch.from_numpy(frames).to(dev)

    def card_crops():
        return faces.crop_faces(x, boxes, 6, IMG).cpu().numpy().astype(np.int16)

    err = int(np.abs(card_crops() - ref).max())
    pair = faces.crop_resize_weights_pair

    def uncoupled(h, w, box, out):
        return (resize.crop_resize_weights(h, box[0], box[2], out),
                resize.crop_resize_weights(w, box[3], box[1], out))

    faces.crop_resize_weights_pair = uncoupled
    faces._crop_weights.cache_clear()
    try:
        planted = int(np.abs(card_crops() - ref).max())
    finally:
        faces.crop_resize_weights_pair = pair
        faces._crop_weights.cache_clear()
    if ref.shape != (5, IMG, IMG, 3) or err > 1:
        raise AssertionError(f"crop_faces card vs CPU: shape {ref.shape}, max {err} LSB")
    if planted <= 1:
        raise AssertionError("the planted fault (no coupled fallback) passed the crop check")
    t_ms = cuda_ms(torch, lambda: faces.crop_faces(x, boxes, 6, IMG), 5)
    log(f"video [crops]: crop_faces card vs CPU max {err} LSB (limit 1) on 5 crops of 1080x1920 "
        f"frames; planted fault {planted} LSB; {t_ms:.3f} ms per call [{card}]")


def detect_split(torch, np, det, frames_list, dev) -> dict:
    """The device detector's detect_many on frames_list, step by step with
    a synchronize after each device step: where the file path's detect
    stage spends its time."""
    from genconvit_tpu_torch.models.facedet import detect_batch

    ms = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        ms[name] = round((time.perf_counter() - t) * 1e3, 3)
        return r

    with torch.inference_mode():
        wins = [det._windows(*f.shape[1:3]) for f in frames_list]
        xs = step("upload", lambda: [torch.from_numpy(f).to(dev) for f in frames_list])
        crops = step("window_crops", lambda: torch.cat(
            [det.window_crops(x, w) for x, w in zip(xs, wins)]))
        outs = step("detect_batch", lambda: [detect_batch(det.model, c, max_faces=det.max_faces,
                                                          score_thresh=det.score_thresh)
                                             for c in crops.split(det.batch)])
        sc, bx = step("fetch", lambda: (torch.cat([o[0] for o in outs]).cpu().numpy(),
                                        torch.cat([o[1] for o in outs]).cpu().numpy()))

    def host():
        off = 0
        for f, w in zip(frames_list, wins):
            h, wd = f.shape[1:3]
            for _ in range(len(f)):
                det._merge(det._candidates(sc[off: off + len(w)], bx[off: off + len(w)], w, h, wd))
                off += len(w)

    step("candidates_merge_host", host)
    ms["windows"] = int(crops.shape[0])
    return ms


def video_corpus(np):
    """Eight seeded synthetic videos of FRAMES frames (two at each of
    VIDEO_SIZES) with drawn faces, a zero-face one (flat gray, and no
    recorded boxes) and a name whose decode raises."""
    rng = np.random.default_rng(41)
    corpus = {}
    for i, (h, w) in enumerate(s for s in VIDEO_SIZES for _ in range(2)):
        corpus[f"v{i}_{h}p.mp4"] = draw_faces(np, rng, FRAMES, h, w)
    corpus["zero_faces.mp4"] = np.full((FRAMES, 360, 640, 3), 128, np.uint8)
    return corpus


def sidecar_boxes(corpus: dict) -> dict:
    """Recorded boxes: up to two a frame (quirk B7's budget), one that
    up- and one that downscales; none for the zero-face video."""
    out = {}
    for name, frames in corpus.items():
        h, w = frames.shape[1:3]
        big = [h // 8, w - w // 6, h - h // 8, w // 6]
        small = [h // 3, w // 2 + 60, h // 3 + 90, w // 2 - 40]
        out[name] = [[] if name.startswith("zero") else ([big, small] if k % 2 else [big])
                     for k in range(FRAMES)]
    return out


def count_forwards(kcuda, what: str, n_scored: int) -> int:
    """Every forward of the default plan: 54 K1 and 3 K2 launches."""
    got = kcuda.launch_counts()
    want = -(-n_scored // VIDEO_BATCH)
    if got["layer_norm_rows"] != 3 * want or got["ln_mlp_residual"] != 54 * want or any(
            v for k, v in got.items() if k not in ("layer_norm_rows", "ln_mlp_residual")):
        raise AssertionError(f"{what}: launches {got}, want {want} forwards of 54 K1 + 3 K2")
    return want


def capture_launches(pred) -> list:
    """Wrap `pred.forward_batched` (an instance attribute over the method,
    taken away with `del pred.forward_batched`): each launch's faces, mask
    and y_val, in launch order."""
    seen = []
    forward = pred.forward_batched

    def wrapped(frames_u8, mask):
        y, y_val = forward(frames_u8, mask)
        seen.append((frames_u8, mask, y_val))
        return y, y_val

    pred.forward_batched = wrapped
    return seen


def check_recorded(torch, pred, corpus: dict, res: dict, seen: list, dev) -> float:
    """`predict_files_group_detect`'s assembly under 'recorded' boxes: each scored
    video's crops (`crop_faces` of its frames and recorded boxes, padded,
    within 1 LSB) and mask sit in exactly one launch row, no other row holds
    a video, and the verdict returned for the video is that row's, bit for
    bit; `predict_faces` on the same crops gives it within RECORDED_TOL
    (only the batch differs). Returns that max|dy_val|."""
    from genconvit_tpu_torch.data.faces import crop_faces
    from genconvit_tpu_torch.data.preprocess import pad_faces
    from genconvit_tpu_torch.infer.aggregate import DEFAULT_VERDICT

    scored = [n for n in sorted(res) if res[n] not in (None, DEFAULT_VERDICT)]
    rows = [(f, m, y) for faces, mask, y_val in seen
            for f, m, y in zip(faces, mask, y_val) if bool(m.any())]
    if len(rows) != len(scored):
        raise AssertionError(f"{len(rows)} launch rows hold a video, {len(scored)} were scored")
    worst = 0.0
    for n in scored:
        crops = crop_faces(corpus[n], pred.detector.for_video(n).detect(corpus[n]), FRAMES, IMG,
                           device=dev)
        faces, mask = pad_faces(crops, FRAMES, IMG)
        hits = [float(y) for f, m, y in rows if torch.equal(m, mask)
                and int((f.short() - faces.short()).abs().max()) <= 1]
        if hits != [res[n][1]]:
            raise AssertionError(f"{n}: verdict {res[n]}, launch rows holding its crops and "
                                 f"mask gave {hits}")
        one = pred.predict_faces(crops, FRAMES)
        worst = max(worst, abs(one[1] - res[n][1]))
        if abs(one[1] - 0.5) > RECORDED_TOL and one[0] != res[n][0]:
            raise AssertionError(f"{n}: predict_files {res[n]}, predict_faces {one}")
    if not worst <= RECORDED_TOL:
        raise AssertionError(f"recorded verdicts vs predict_faces: {worst} > {RECORDED_TOL}")
    return worst


def planted_assembly_faults(torch, pred, corpus: dict, names: list, dev) -> list:
    """Assembly faults that `check_recorded` must refuse: two videos' faces
    swapped in a launch; the first video's mask one frame off."""
    launch = pred._launch

    def swapped(faces, masks, video_batch):
        faces = list(faces)
        faces[0], faces[1] = faces[1], faces[0]
        return launch(faces, masks, video_batch)

    def mask_off(faces, masks, video_batch):
        m = masks[0].clone()
        k = int(m.sum())
        m[k if k < len(m) else k - 1] = 1.0 if k < len(m) else 0.0
        return launch(faces, [m] + list(masks[1:]), video_batch)

    refused = []
    for what, fault in (("faces of two videos swapped", swapped), ("mask one frame off", mask_off)):
        pred._launch = fault
        seen = capture_launches(pred)
        try:
            res = dict(pred.predict_files(names, FRAMES, video_batch=VIDEO_BATCH))
        finally:
            del pred._launch, pred.forward_batched
        try:
            check_recorded(torch, pred, corpus, res, seen, dev)
        except AssertionError as e:
            refused.append(f"{what}: {str(e)[:80]}")
            continue
        raise AssertionError(f"the planted assembly fault ({what}) passed the recorded check")
    return refused


def phase_video(torch, np, dev, card: str, tmp: str) -> dict:
    """Phase 11: the video-to-verdict path on the card (see the module
    docstring). So that it runs without cv2 or FFmpeg, the drivers' decode,
    `engine.extract_frames`, is substituted by an in-memory source of the
    seeded frames for the whole phase (and put back after). The weights go
    to `tmp`, where phase 12 reads them."""
    import os

    from genconvit_tpu_torch import prediction
    from genconvit_tpu_torch.data.faces import make_detector
    from genconvit_tpu_torch.infer import engine
    from genconvit_tpu_torch.infer.aggregate import DEFAULT_VERDICT
    from genconvit_tpu_torch.ops import cuda as kcuda

    video_detector(torch, np, dev, card)
    video_crops(torch, np, dev, card)
    corpus = video_corpus(np)

    alias = {}   # the timed run's copies: name -> the corpus video it repeats

    def in_memory(path, num_frames, prefer_native=True):
        name = os.path.basename(path)
        name = alias.get(name, name)
        if name not in corpus:
            raise IOError(f"cannot open video: {path}")
        return corpus[name][:num_frames]

    decode = engine.extract_frames
    engine.extract_frames = in_memory
    env = os.environ.get("GENCONVIT_FACE_SIDECAR")
    out = {}
    try:
        w = video_weights(torch, dev, tmp)
        t = time.perf_counter()
        pred = engine.Predictor(backbone_config("convnext_tiny"), device=dev,
                                ed_weight=w["paths"]["ed"], vae_weight=w["paths"]["vae_pth"],
                                face_backend="jax", deterministic_vae=True)
        torch.cuda.synchronize()
        log(f"video [weights]: Predictor(ed_weight=.gcv, vae_weight=.pth) "
            f"{time.perf_counter() - t:.2f} s, detector {type(pred.detector).__name__}")
        check_loaded(torch, pred, w["sd"])
        log("video [weights]: the Predictor's tensors equal the written ones cast to bf16")
        os.remove(w["paths"]["vae_pth"])   # one 2.5 GB file on disk at a time
        video_chunked_vae(torch, w["sd"]["vae"], w["paths"]["vae"])
        side = os.path.join(tmp, "boxes.json")
        with open(side, "w") as f:
            json.dump(sidecar_boxes(corpus), f)
        names = sorted(corpus) + ["broken.mp4"]
        for backend in ("jax", "recorded", "center"):
            pred.detector = make_detector(backend, device=dev, **(
                {"sidecar_path": side} if backend == "recorded" else {}))
            kcuda.reset_launch_counts()
            seen = capture_launches(pred)
            t = time.perf_counter()
            try:
                res = dict(pred.predict_files(names, FRAMES, video_batch=VIDEO_BATCH))
            finally:
                del pred.forward_batched
            dt = time.perf_counter() - t
            if res["broken.mp4"] is not None:
                raise AssertionError(f"[{backend}] the failed decode gave {res['broken.mp4']}")
            scored = [n for n in names if res[n] not in (None, DEFAULT_VERDICT)]
            fwd = count_forwards(kcuda, f"predict_files [{backend}]", len(scored))
            ys = np.array([res[n][0] for n in scored])
            vals = np.array([res[n][1] for n in scored], np.float64)
            check_verdicts(np, ys, vals, len(scored))
            log(f"video [{backend}]: predict_files of {len(names)} videos {dt:.2f} s, "
                f"{len(scored)} scored in {fwd} forwards (54 K1 + 3 K2 each), verdicts "
                f"{[(n, res[n]) for n in names]} [{card}]")
            if backend == "recorded":
                if res["zero_faces.mp4"] != DEFAULT_VERDICT:
                    raise AssertionError(f"zero faces gave {res['zero_faces.mp4']}")
                worst = check_recorded(torch, pred, corpus, res, seen, dev)
                refused = planted_assembly_faults(torch, pred, corpus, names, dev)
                log(f"video [recorded]: each verdict is its own launch row's (its crops within "
                    f"1 LSB, its mask exact); vs predict_faces on its crops max|dy_val| "
                    f"{worst:.3e} (limit {RECORDED_TOL}); planted assembly faults refused: "
                    f"{refused} [{card}]")
            if backend == "jax":
                fired = [sum(bool(b) for b in boxes) for boxes in pred.detector.detect_many(
                    [corpus[n] for n in sorted(corpus)])]
                log(f"video [jax]: frames in which the detector fired, per video "
                    f"{dict(zip(sorted(corpus), fired))} of {FRAMES} (synthetic frames: "
                    f"printed, not checked)")
                video_detect_many(torch, np, pred.detector, corpus, card)
        # f. timings: the device detector's path again, warm, decode excluded:
        # the eight face videos TIMED_COPIES times, TIMED_RUNS runs
        pred.detector = make_detector("jax", device=dev)
        copies = {f"c{k}_{n}": n for k in range(TIMED_COPIES) for n in sorted(corpus)
                  if not n.startswith("zero")}
        alias.update(copies)
        paths = list(copies)   # each group of eight holds the eight videos once
        torch.cuda.reset_peak_memory_stats(dev)
        runs = []
        for _ in range(TIMED_RUNS):
            pred.timers.reset()
            t = time.perf_counter()
            got = pred.predict_files(paths, FRAMES, video_batch=VIDEO_BATCH)
            dt = time.perf_counter() - t
            if any(v is None for _, v in got):
                raise AssertionError("the timed run lost a video")
            runs.append((len(paths) / dt, dt, pred.timers.summary()))
            log(f"video [timing]: predict_files 'jax' over {len(paths)} videos in "
                f"{len(paths) // VIDEO_BATCH} groups of {VIDEO_BATCH}: {runs[-1][0]:.2f} "
                f"videos/s ({dt:.3f} s), stages {runs[-1][2]} [{card}]")
        rates = sorted(r[0] for r in runs)
        med = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
        out["videos_s"], out["spread"], out["stages"] = med[0], (rates[0], rates[-1]), med[2]
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"video [timing]: predict_files 'jax' at video_batch={VIDEO_BATCH}, {len(paths)} "
            f"videos (the eight {TIMED_COPIES} times, decode substituted by memory), "
            f"{TIMED_RUNS} runs: median {out['videos_s']:.2f} videos/s, min {rates[0]:.2f}, "
            f"max {rates[-1]:.2f}; the median run's stages {out['stages']}; peak device "
            f"memory {out['peak_gib']:.2f} GiB [{card}]")
        paths = sorted(corpus)[:VIDEO_BATCH]
        out["detect_split"] = detect_split(torch, np, pred.detector,
                                           [corpus[n] for n in paths], dev)
        log(f"video [timing]: the device detector on those {len(paths)} videos, ms: "
            f"{out['detect_split']} (uploads, window crops, detect_batch passes, each "
            f"synchronized; boxes fetched; candidates and merge on the host) [{card}]")
        del pred
        torch.cuda.empty_cache()
        # e. the CLI in-process: weights resolved by name in --weights-dir
        vdir = os.path.join(tmp, "videos")
        os.makedirs(vdir)
        for n in names:
            open(os.path.join(vdir, n), "wb").close()
        t = time.perf_counter()
        path = prediction.main(["--p", vdir, "--f", str(FRAMES), "--face-backend", "recorded",
                                "--face-sidecar", side, "--weights-dir", tmp,
                                "--result-dir", os.path.join(tmp, "result")])
        dt = time.perf_counter() - t
        with open(path) as f:
            result = json.load(f)
        keys = {"name", "pred", "klass", "pred_label", "correct_label"}
        meta = {"dataset", "network", "num_frames", "runtime_seconds", "timestamp", "framework"}
        if set(result) != {"video", "metadata"} or set(result["video"]) != keys \
                or set(result["metadata"]) != meta or result["video"]["name"] != sorted(names):
            raise AssertionError(f"CLI result: keys {sorted(result)}, video "
                                 f"{sorted(result['video'])}, names {result['video']['name']}")
        log(f"video [CLI]: prediction.main over {len(names)} placeholder files {dt:.2f} s "
            f"(weights resolved by name: ed .gcv, vae chunked .gcv), labels "
            f"{result['video']['pred_label']} [{card}]")
    finally:
        engine.extract_frames = decode
        if env is None:
            os.environ.pop("GENCONVIT_FACE_SIDECAR", None)
        else:
            os.environ["GENCONVIT_FACE_SIDECAR"] = env
    out["corpus"] = corpus
    return out


# ---------------------------------------------------------------- phase 12

SERVE_MODES = (("staged", 0.0), ("micro", 8.0), ("none", None))   # (--batcher, window ms)
SERVE_TOL = 2e-3     # a served verdict vs predict_video on the same video: the same bf16
                     # path, only the batch differs (RECORDED_TOL's bound)
SERVE_COPIES = 8     # each mode scores the eight face videos this many times,
SERVE_CONCURRENCY = 8  # eight requests at a time
HTTP_TIMEOUT = 120
STREAM_BATCHES = 4
EVAL_IMAGES = 64
EVAL_BATCH = 32


def http_call(url: str, data=None) -> tuple:
    """(status, JSON body) of one GET (data None) or POST to the local
    server, with no proxy and a timeout."""
    import urllib.error
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    try:
        with opener.open(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.load(e)


def drive_server(url: str, bodies: list) -> tuple:
    """POST each body, SERVE_CONCURRENCY at a time: ([(status, JSON,
    seconds)] in order, wall seconds)."""
    import concurrent.futures as cf

    def one(body):
        t = time.perf_counter()
        code, js = http_call(url + "/predict", body)
        return code, js, time.perf_counter() - t

    t = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=SERVE_CONCURRENCY) as ex:
        res = list(ex.map(one, bodies))
    return res, time.perf_counter() - t


def check_served(names: list, res: list, ref: dict) -> float:
    """Each response is 200 with faces, its pred within SERVE_TOL of
    predict_video on the same video and its y the same wherever that
    verdict is decisive. Returns max|d pred|."""
    worst, bad = 0.0, []
    for name, (code, js, _) in zip(names, res):
        y, y_val = ref[name]
        if code != 200 or js.get("faces_found", 0) <= 0:
            bad.append((name, code, js))
            continue
        d = abs(js["pred"] - y_val)
        worst = max(worst, d)
        if d > SERVE_TOL or (abs(y_val - 0.5) > SERVE_TOL and js["y"] != y):
            bad.append((name, js["y"], js["pred"], ref[name]))
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} served verdicts differ from "
                             f"predict_video: {bad[:3]}")
    return worst


class LocalServer:
    """`serve.make_handler` under ThreadingHTTPServer on 127.0.0.1:0 in a
    thread, in one mode; shut down with its batching stage on exit."""

    def __init__(self, pred, mode: str, window_ms):
        from genconvit_tpu_torch import serve
        from genconvit_tpu_torch.infer.batcher import MicroBatcher
        from genconvit_tpu_torch.infer.serve_pipeline import StagedPipeline

        self.batcher = (MicroBatcher(pred, FRAMES, window_ms=window_ms, max_batch=VIDEO_BATCH)
                        if mode == "micro" else None)
        self.pipeline = (StagedPipeline(pred, FRAMES, max_batch=VIDEO_BATCH, window_ms=window_ms)
                         if mode == "staged" else None)
        self.handler = serve.make_handler(pred, FRAMES, self.batcher, self.pipeline)

    def __enter__(self) -> str:
        import threading
        from http.server import ThreadingHTTPServer

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), self.handler)
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        return f"http://127.0.0.1:{self.srv.server_port}"

    def __exit__(self, *exc) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)
        for stage in (self.batcher, self.pipeline):
            if stage is not None:
                stage.close()
        if self.thread.is_alive():
            raise AssertionError("the server thread did not stop")


def serve_modes(torch, np, pred, card: str, ref: dict, aliases: dict) -> dict:
    """12a: the server in each mode; then the planted reverse-order fault."""
    from genconvit_tpu_torch.ops import cuda as kcuda

    names = list(aliases)            # the eight videos, eight times, k-major
    bodies = [n.encode() for n in names]
    want = [aliases[n] for n in names]
    out = {}
    for mode, window in SERVE_MODES:
        with LocalServer(pred, mode, window) as url:
            kcuda.reset_launch_counts()
            pred.timers.reset()
            seen = capture_launches(pred)
            try:
                res, wall = drive_server(url, bodies)
            finally:
                del pred.forward_batched
            counts = kcuda.launch_counts()
            stages = {k: (v["total_seconds"], v["count"]) for k, v in pred.timers.summary().items()}
            statz = http_call(url + "/statz")[1]
            worst = check_served(want, res, ref)
            fwd = len(seen)
            widths = [int(f.shape[0]) for f, _, _ in seen]
            if counts["ln_mlp_residual"] != 54 * fwd or counts["layer_norm_rows"] != 3 * fwd or any(
                    v for k, v in counts.items() if k not in ("ln_mlp_residual", "layer_norm_rows")):
                raise AssertionError(f"[{mode}] launches {counts}, want {fwd} forwards of 54 K1 + 3 K2")
            if mode == "none":
                if statz != {"mode": "lock-serialized"} or fwd != len(names):
                    raise AssertionError(f"[none] /statz {statz}, {fwd} forwards for {len(names)}")
            elif (statz["mode"] != ("staged" if mode == "staged" else "micro-batched")
                  or statz["videos_scored"] != len(names) or statz["device_launches"] != fwd
                  or not fwd < len(names) or max(widths) < 2 or sum(widths) != len(names)):
                raise AssertionError(f"[{mode}] /statz {statz}, launch widths {widths}")
            extra = {"zero faces": http_call(url + "/predict", b"zero_faces.mp4"),
                     "failed decode": http_call(url + "/predict", b"broken.mp4"),
                     "empty body": http_call(url + "/predict", b""),
                     "garbage body": http_call(url + "/predict", bytes(range(256)) * 4),
                     "unknown path": http_call(url + "/nope"),
                     "unknown POST": http_call(url + "/nope", b"x"),
                     "healthz": http_call(url + "/healthz")}
        zero = extra["zero faces"]
        if zero[0] != 200 or (zero[1]["y"], zero[1]["pred"], zero[1]["faces_found"]) != (0, 0.5, 0):
            raise AssertionError(f"[{mode}] zero faces: {zero}")
        if extra["failed decode"][0] != 500 or "broken.mp4" not in extra["failed decode"][1]["error"]:
            raise AssertionError(f"[{mode}] failed decode: {extra['failed decode']}")
        codes = {k: extra[k][0] for k in ("empty body", "garbage body", "unknown path",
                                           "unknown POST", "healthz")}
        if codes != {"empty body": 400, "garbage body": 500, "unknown path": 404,
                     "unknown POST": 404, "healthz": 200}:
            raise AssertionError(f"[{mode}] status codes {codes}")
        lat = np.array([s for _, _, s in res]) * 1e3
        out[mode] = {"rps": len(names) / wall, "p50_ms": float(np.percentile(lat, 50)),
                     "p95_ms": float(np.percentile(lat, 95)), "launches": fwd,
                     "per_launch": len(names) / fwd, "widths": widths, "worst": worst,
                     "stages": stages}
        r = out[mode]
        log(f"serve [{mode}]: {len(names)} requests at concurrency {SERVE_CONCURRENCY}: "
            f"{r['rps']:.2f} requests/s ({wall:.3f} s), latency p50 {r['p50_ms']:.1f} ms, p95 "
            f"{r['p95_ms']:.1f} ms; {fwd} device launches ({r['per_launch']:.2f} videos a launch, "
            f"widths {widths}); {counts['ln_mlp_residual']} K1 + {counts['layer_norm_rows']} K2; "
            f"StageTimers (seconds summed over threads, count) {stages}; "
            f"max|d pred| vs predict_video {worst:.3e} (limit {SERVE_TOL}); /statz {statz}; "
            f"zero faces {zero[1]}, failed decode 500 '{extra['failed decode'][1]['error']}', "
            f"codes {codes} [{card}]")
    # the planted fault: a staged pipeline that hands each drain's results
    # out in reverse order (a 30 ms window, so that drains hold several videos)
    launch = pred._launch
    pred._launch = lambda faces, masks, vb: launch(faces, masks, vb).flip(1)
    try:
        with LocalServer(pred, "staged", 30.0) as url:
            res, _ = drive_server(url, bodies[:2 * VIDEO_BATCH])
    finally:
        del pred._launch
    try:
        check_served(want[:2 * VIDEO_BATCH], res, ref)
    except AssertionError as e:
        log(f"serve [planted]: results handed out in reverse order refused: {str(e)[:160]}")
    else:
        raise AssertionError("the planted fault (a drain's results reversed) passed the check")
    return out


def serve_stream(torch, np, pred, card: str) -> dict:
    """12b: predict_videos_stream over STREAM_BATCHES [8,15,224,224,3]
    batches equals predict_videos_batched on each, bit for bit; timed
    against the four calls one after the other."""
    from genconvit_tpu_torch.ops import cuda as kcuda

    rng = np.random.default_rng(12)
    batches = []
    for _ in range(STREAM_BATCHES):
        mask = np.ones((VIDEO_BATCH, FRAMES), np.float32)
        mask[1, 9:] = 0
        batches.append((rng.integers(0, 256, (VIDEO_BATCH, FRAMES, IMG, IMG, 3), np.uint8), mask))
    kcuda.reset_launch_counts()
    got = pred.predict_videos_stream(iter(batches))
    counts = kcuda.launch_counts()
    if counts["ln_mlp_residual"] != 54 * STREAM_BATCHES or counts["layer_norm_rows"] != 3 * STREAM_BATCHES:
        raise AssertionError(f"stream launches {counts}")
    for i, ((gy, gv), (f, m)) in enumerate(zip(got, batches, strict=True)):
        wy, wv = pred.predict_videos_batched(f, m)
        if not (np.array_equal(gy, wy) and np.array_equal(gv, wv)):
            raise AssertionError(f"stream batch {i}: {gy.tolist()} {gv.tolist()} vs batched "
                                 f"{wy.tolist()} {wv.tolist()}")
    times = {"stream": [], "sequential": []}
    for _ in range(2):   # stream, sequential, stream, sequential
        for kind in times:
            torch.cuda.synchronize()
            t = time.perf_counter()
            if kind == "stream":
                pred.predict_videos_stream(iter(batches))
            else:
                for f, m in batches:
                    pred.predict_videos_batched(f, m)
            times[kind].append((time.perf_counter() - t) * 1e3)
    log(f"serve [stream]: predict_videos_stream over {STREAM_BATCHES} batches of "
        f"[{VIDEO_BATCH},{FRAMES},{IMG},{IMG},3] "
        f"equals predict_videos_batched on each, bit for bit; {counts['ln_mlp_residual']} K1 + "
        f"{counts['layer_norm_rows']} K2; ms, stream {[round(t, 2) for t in times['stream']]} "
        f"against {STREAM_BATCHES} predict_videos_batched calls "
        f"{[round(t, 2) for t in times['sequential']]} [{card}]")
    return times


def serve_prediction_v2(np, tmp: str, corpus: dict, card: str) -> None:
    """12c: prediction_v2.main in-process over placeholder files named with
    and without 'fake', recorded boxes: the JAX package's result keys and a
    metrics block computed with no sklearn; its verdicts are the
    `prediction` CLI's on the same files."""
    import os

    from genconvit_tpu_torch import prediction, prediction_v2
    from genconvit_tpu_torch.infer.result import compute_metrics

    vdir = os.path.join(tmp, "v2")
    os.makedirs(vdir)
    boxes = sidecar_boxes(corpus)
    side = {}
    for i, n in enumerate(sorted(corpus) + ["broken.mp4"]):
        fname = f"fake_{n}" if i % 2 == 0 else n
        with open(os.path.join(vdir, fname), "w") as f:
            f.write(n)
        side[fname] = boxes.get(n, [])
    side_path = os.path.join(tmp, "boxes_v2.json")
    with open(side_path, "w") as f:
        json.dump(side, f)
    os.environ["GENCONVIT_FACE_SIDECAR"] = side_path
    t = time.perf_counter()
    path = prediction_v2.main(["--p", vdir, "--f", str(FRAMES), "--face-backend", "recorded",
                               "--weights-dir", tmp, "--result-dir", os.path.join(tmp, "result_v2")])
    dt = time.perf_counter() - t
    if "sklearn" in sys.modules:
        raise AssertionError("prediction_v2 loaded sklearn")
    with open(path) as f:
        result = json.load(f)
    meta = {"dataset", "network", "num_frames", "runtime_seconds", "timestamp", "framework",
            "arch_type", "model_size", "stage_timers"}
    video = result["video"]
    if set(result) != {"video", "metrics", "metadata"} or set(result["metadata"]) != meta \
            or set(video) != {"name", "pred", "klass", "pred_label", "correct_label"} \
            or set(result["metrics"]) != {"accuracy", "precision", "recall", "f1"}:
        raise AssertionError(f"prediction_v2 result keys: {sorted(result)}, "
                             f"{sorted(result.get('metadata', {}))}, {sorted(video)}")
    labels = ["FAKE" if "fake" in n.lower() else "REAL" for n in video["name"]]
    y_true = [int(c == "FAKE") for c in video["correct_label"]]
    y_pred = [int(c == "FAKE") for c in video["pred_label"]]
    if video["correct_label"] != labels or result["metrics"] != compute_metrics(y_true, y_pred):
        raise AssertionError(f"prediction_v2 labels {video['correct_label']} (want {labels}), "
                             f"metrics {result['metrics']}")
    path1 = prediction.main(["--p", vdir, "--f", str(FRAMES), "--face-backend", "recorded",
                             "--face-sidecar", side_path, "--weights-dir", tmp,
                             "--result-dir", os.path.join(tmp, "result_v1")])
    with open(path1) as f:
        v1 = json.load(f)["video"]
    if v1["name"] != video["name"] or v1["pred"] != video["pred"] \
            or v1["pred_label"] != video["pred_label"]:
        raise AssertionError(f"prediction_v2 verdicts {list(zip(video['name'], video['pred']))} "
                             f"!= prediction's {v1['pred']}")
    log(f"serve [prediction_v2]: main over {len(video['name'])} placeholder files {dt:.2f} s, "
        f"no sklearn loaded; metrics {result['metrics']}; verdicts equal the prediction CLI's "
        f"{list(zip(video['name'], video['pred']))} [{card}]")


def serve_evaluate(torch, np, dev, pred, tmp: str, card: str) -> dict:
    """12d: evaluate's scoring over EVAL_IMAGES seeded 224 px face images in
    an ImageFolder of placeholder files (`folder.load_image` substituted by
    memory), at batch EVAL_BATCH: P(class 1) within YVAL_TOL of the port's
    float32 plain path on the same weights (TF32 off); the report."""
    import os

    from genconvit_tpu_torch import evaluate
    from genconvit_tpu_torch.data import folder
    from genconvit_tpu_torch.infer import engine
    from genconvit_tpu_torch.ops import cuda as kcuda

    rng = np.random.default_rng(13)
    edir = os.path.join(tmp, "eval", "test")
    images = {}
    for cls in ("fake", "real"):
        os.makedirs(os.path.join(edir, cls))
        for i in range(EVAL_IMAGES // 2):
            path = os.path.join(edir, cls, f"{i:02d}.png")
            open(path, "wb").close()
            images[path] = draw_faces(np, rng, 1, IMG, IMG)[0]
    load = folder.load_image
    folder.load_image = lambda path, img_size=None: images[path]
    try:
        ds = folder.FolderDataset(edir, IMG)
        kcuda.reset_launch_counts()
        t = time.perf_counter()
        y_true, p16 = evaluate.score_batches(pred, ds.batches(EVAL_BATCH))
        dt = time.perf_counter() - t
        counts = kcuda.launch_counts()
        fwd = -(-EVAL_IMAGES // EVAL_BATCH)
        if counts["ln_mlp_residual"] != 54 * fwd or counts["layer_norm_rows"] != 3 * fwd:
            raise AssertionError(f"evaluate launches {counts}, want {fwd} forwards of 54 K1 + 3 K2")
        cfg = backbone_config("convnext_tiny")
        cfg.weight_dir = tmp
        p32 = engine.Predictor(cfg, device=dev, dtype=torch.float32, deterministic_vae=True,
                               face_backend="center")
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            y32, ref = evaluate.score_batches(p32, ds.batches(EVAL_BATCH))
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        del p32
        torch.cuda.empty_cache()
    finally:
        folder.load_image = load
    dp = float(np.abs(p16 - ref).max())
    if not (np.array_equal(y_true, y32) and y_true.shape == (EVAL_IMAGES,)
            and np.all(np.isfinite(p16)) and dp <= YVAL_TOL):
        raise AssertionError(f"evaluate: max|dP| {dp} (limit {YVAL_TOL}), labels {y_true.tolist()}")
    text, cm, auc = evaluate.report(y_true, p16, ds.classes)
    log(f"serve [evaluate]: score_batches over {EVAL_IMAGES} images at batch {EVAL_BATCH} "
        f"{dt:.3f} s ({counts['ln_mlp_residual']} K1 + {counts['layer_norm_rows']} K2); "
        f"max|dP(class 1)| vs the f32 plain path {dp:.3e} (limit {YVAL_TOL}); P range "
        f"[{p16.min():.4f}, {p16.max():.4f}]; ROC-AUC {auc}; confusion {cm.tolist()} [{card}]")
    for line in text.rstrip().splitlines():
        log(f"  {line}")
    return {"dp": dp}


def phase_serve(torch, np, dev, card: str, tmp: str, corpus: dict) -> dict:
    """Phase 12: the serving path and the remaining entry points on the card
    (see the module docstring), on phase 11's weights (read from `tmp` by
    name) and corpus. The decode, `engine.extract_frames`, is substituted
    for the whole phase (and put back after) by the corpus in memory: each
    request's body, and each placeholder file, holds the name of the video
    it stands for."""
    import os

    from genconvit_tpu_torch.infer import engine

    faces = sorted(n for n in corpus if not n.startswith("zero"))
    aliases = {f"s{k}_{n}": n for k in range(SERVE_COPIES) for n in faces}

    def in_memory(path, num_frames, prefer_native=True):
        with open(path, "rb") as f:
            name = f.read().decode("utf-8", "replace")
        name = aliases.get(name, name)
        if name not in corpus:
            raise IOError(f"cannot open video: {name[:40]!r}")
        return corpus[name][:num_frames]

    decode = engine.extract_frames
    engine.extract_frames = in_memory
    env = os.environ.get("GENCONVIT_FACE_SIDECAR")
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    try:
        cfg = backbone_config("convnext_tiny")
        cfg.weight_dir = tmp
        t = time.perf_counter()
        pred = engine.Predictor(cfg, device=dev, face_backend="jax", deterministic_vae=True)
        s = IMG   # the server's warm-up: one forward at the widest launch
        pred.predict_videos_batched(np.zeros((VIDEO_BATCH, FRAMES, s, s, 3), np.uint8),
                                    np.ones((VIDEO_BATCH, FRAMES), np.float32))
        vdir = os.path.join(tmp, "serve")
        os.makedirs(vdir)
        ref = {}
        for n in faces:
            with open(os.path.join(vdir, n), "w") as f:
                f.write(n)
            ref[n] = pred.predict_video(os.path.join(vdir, n), FRAMES)
        log(f"serve: Predictor from the .gcv files by name, warm-up and predict_video of the "
            f"{len(faces)} face videos {time.perf_counter() - t:.2f} s; verdicts {ref} [{card}]")
        out["modes"] = serve_modes(torch, np, pred, card, ref, aliases)
        out["stream"] = serve_stream(torch, np, pred, card)
        out["evaluate"] = serve_evaluate(torch, np, dev, pred, tmp, card)
        del pred
        torch.cuda.empty_cache()
        serve_prediction_v2(np, tmp, corpus, card)
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    finally:
        engine.extract_frames = decode
        if env is None:
            os.environ.pop("GENCONVIT_FACE_SIDECAR", None)
        else:
            os.environ["GENCONVIT_FACE_SIDECAR"] = env
    return out


# ---------------------------------------------------------------- phase 13

TRAIN_BATCH = 32       # 13a's float32 and default-plan steps, 13d's timing
TRAIN_BATCH_SMALL = 8  # 13a's other plans, 13b's planted faults
TRAIN_FACTOR = 3.0     # 13a: a kernel plan's error against the f32 step at most this times
TRAIN_FLOOR = 1e-3     # pallas '0''s bf16 error at the same batch (or this floor, if larger)
TRAIN_FAULT_LR = 1e-2  # 13b: the step before the stale-fold check moves the weights measurably
FEATURE_TOL = 3e-2     # 13b: kernel backbone vs the reference graph, relative L2 of the features
FOLDED_TOL = 0.5       # 13b: LN-folded blocks' norm and fc1 gradient vs f32, relative L2
BN_TOL = 1e-4          # 13b: BN0's running mean vs (1 - m) old + m batch mean, relative
TRAIN_STEPS = 8        # 13d: steps on one batch; the loss must fall
TIMED_STEPS = 3        # 13d: steps a timed run
CLI_IMAGES = (8, 4, 4)  # 13e: images a class in train, valid, test
# 13a's bf16 runs: (name, pallas, int8_mlp, batch); "pallas=0" is each batch's yardstick
TRAIN_PLANS = (("default", "", "", TRAIN_BATCH), ("pallas=0", "0", "", TRAIN_BATCH),
               ("pallas=0", "0", "", TRAIN_BATCH_SMALL),
               ("int8_mlp=fc1", "", "fc1", TRAIN_BATCH_SMALL),
               ("pallas=1", "1", "", TRAIN_BATCH_SMALL),
               ("pallas=stage", "stage", "", TRAIN_BATCH_SMALL))
# the blocks every backbone call of 224 px runs LN-folded under pallas '1'
# (stages 2-3: H = 14 and 7), whose norm and fc1 take their gradient through
# Block.fold_ln only
FOLDED = r"^(ed\.backbone|vae\.convnext_backbone)\.stages\.[23]\.blocks\.\d+\.(norm|mlp\.fc1)\."
GROUPS = {"ed": r"^ed\.", "vae": r"^vae\.", "ed backbone": r"^ed\.backbone\.",
          "vae backbone": r"^vae\.convnext_backbone\.", "LN-folded norm+fc1": FOLDED}


class TrainBench:
    """Phase 13's state: the float32 master model (convnext_tiny GenConViT,
    full width and depth, random weights from a seed, layer scale U(0.1,
    1)), its weights w0, one seeded uint8 batch, labels and eps."""

    def __init__(self, torch, dev, config, net: str = "genconvit"):
        import re

        from genconvit_tpu_torch.models.convnext import Block
        from genconvit_tpu_torch.train import loop

        self.torch, self.dev, self.net = torch, dev, net
        self.model = loop.new_model(config, net, dev, seed=13)
        g = torch.Generator(device=dev).manual_seed(13)
        with torch.no_grad():
            for m in self.model.modules():
                if isinstance(m, Block):
                    m.gamma.uniform_(0.1, 1.0, generator=g)
        self.w0 = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        s = config.img_size
        self.x = torch.randint(0, 256, (TRAIN_BATCH, s, s, 3), dtype=torch.uint8, device=dev,
                               generator=g)
        self.y = torch.randint(0, 2, (TRAIN_BATCH,), device=dev, generator=g)
        self.eps = torch.randn((TRAIN_BATCH, self.model.vae.encoder.mu.out_features),
                               device=dev, generator=g)
        groups = {k: [n for n, _ in self.model.named_parameters() if re.match(rx, n)]
                  for k, rx in GROUPS.items()}
        self.groups = {k: names for k, names in groups.items() if names}

    def trainer(self, dtype, plan, n: int, lr: float = 1e-4):
        """A new run from w0 (a fresh optimizer, gradients None): a function
        that takes one train step on the first n images and returns its
        loss."""
        from genconvit_tpu_torch.train import loop, optim

        self.model.load_state_dict(self.w0)
        self.model.zero_grad(set_to_none=True)
        opt = optim.make_optimizer(self.model.parameters(), lr, 1e-4)
        step = loop.make_train_step(self.model, self.net, opt, False, dtype, plan)
        x, y, eps = self.x[:n], self.y[:n], self.eps[:n].to(dtype)
        return lambda: float(step(x, y, eps)[0])

    def step(self, dtype, plan, n: int, lr: float = 1e-4, steps: int = 1):
        """steps train steps of a new run: (losses, launch counts)."""
        from genconvit_tpu_torch.ops import cuda as kcuda

        run = self.trainer(dtype, plan, n, lr)
        kcuda.reset_launch_counts()
        losses = [run() for _ in range(steps)]
        return losses, kcuda.launch_counts()

    def snapshot(self) -> dict:
        """Each parameter's gradient and change from w0, float32 copies."""
        return {n: (p.grad.detach().float().clone(), (p.detach() - self.w0[n]).float())
                for n, p in self.model.named_parameters()}

    def errors(self, ref: dict) -> dict:
        """Relative L2 error of the gradient and of the parameter change
        against `ref` (a snapshot), per group."""
        torch = self.torch
        params = dict(self.model.named_parameters())
        out = {}
        for group, names in self.groups.items():
            acc = torch.zeros(4, dtype=torch.float64, device=self.dev)
            for n in names:
                p = params[n]
                g, d = p.grad.float(), (p.detach() - self.w0[n]).float()
                rg, rd = ref[n]
                acc += torch.stack([(g - rg).double().square().sum(), rg.double().square().sum(),
                                    (d - rd).double().square().sum(), rd.double().square().sum()])
            e = acc.sqrt().tolist()
            out[group] = (e[0] / max(e[1], 1e-30), e[2] / max(e[3], 1e-30))
        return out

    def var_moved(self, lr: float = 1e-4) -> float:
        """mean |change| of the VAE's var head over lr: its gradient is zero
        without the KL term, so only the decay moves it (about lr)."""
        p = self.model.vae.encoder.var.weight
        return float((p.detach() - self.w0["vae.encoder.var.weight"]).abs().mean()) / lr

    def bn0_error(self, n: int) -> float:
        """BN0's running mean after one float32 step against (1 - m) * old +
        m * the batch mean of its input (conv0 of the normalized batch),
        relative to the latter's max."""
        torch = self.torch
        from genconvit_tpu_torch.data.preprocess import normalize_batch
        from genconvit_tpu_torch.ops.conv import conv2d

        feats = self.model.vae.encoder.features
        with torch.no_grad():
            w, b = self.w0["vae.encoder.features.0.weight"], self.w0["vae.encoder.features.0.bias"]
            h = conv2d(normalize_batch(self.x[:n], torch.float32), w, b, stride=2, padding=1)
            want = 0.9 * self.w0["vae.encoder.features.1.running_mean"] + 0.1 * h.mean(dim=(0, 2, 3))
            return float((feats[1].running_mean - want).abs().max() / want.abs().max())


def train_plan_errors(torch, tb: TrainBench, card: str) -> tuple:
    """13a and 13c: one step from w0 in float32 (batch 32 and 8), then under
    bf16 in each plan of TRAIN_PLANS; the loss, each group's gradient and
    parameter change against the f32 step of the same batch; every kernel
    plan within TRAIN_FACTOR of pallas '0' at its batch; launches per step
    equal to expected_launches' per forward twice over (forward and the
    remat recompute); the var head moved by its decay in every run."""
    from genconvit_tpu_torch.ops import cuda as kcuda

    refs, rec = {}, {}
    for n in (TRAIN_BATCH, TRAIN_BATCH_SMALL):
        t = time.perf_counter()
        losses, counts = tb.step(torch.float32, make_plan("0", "", False), n)
        refs[n] = (losses[0], tb.snapshot())
        if any(counts.values()):
            raise AssertionError(f"train f32 N={n}: kernel launches {counts}")
        if tb.var_moved() < 0.5:
            raise AssertionError(f"train f32 N={n}: var head moved {tb.var_moved():.3f} lr")
        rec[("f32", n)] = {"bn0": tb.bn0_error(n), "loss": losses[0]}
        log(f"train 13a f32 N={n}: loss {losses[0]:.6f}, BN0 running mean vs (1-m) old + m "
            f"batch {rec[('f32', n)]['bn0']:.2e}, var head moved {tb.var_moved():.3f} lr, "
            f"{time.perf_counter() - t:.2f} s [{card}]")
        if rec[("f32", n)]["bn0"] > BN_TOL:
            raise AssertionError(f"train f32 N={n}: BN0 running mean off by {rec[('f32', n)]['bn0']}")
    for name, pallas, int8_mlp, n in TRAIN_PLANS:
        t = time.perf_counter()
        losses, counts = tb.step(torch.bfloat16, make_plan(pallas, int8_mlp, False), n)
        want = dict.fromkeys(counts, 0)
        if pallas != "0":
            want = {k: 2 * v for k, v in expected_launches(kcuda, pallas, int8_mlp, False).items()}
        if counts != want:
            raise AssertionError(f"train {name} N={n}: launches {counts}, want {want}")
        errs = tb.errors(refs[n][1])
        dl = abs(losses[0] - refs[n][0]) / abs(refs[n][0])
        rec[(name, n)] = {"loss": losses[0], "dloss": dl, "errs": errs, "counts": counts,
                          "var_moved": tb.var_moved()}
        shown = {k: v for k, v in counts.items() if v}
        log(f"train 13a {name} bf16 N={n}: loss {losses[0]:.6f} (f32 {refs[n][0]:.6f}, rel "
            f"{dl:.2e}); launches a step {shown}; var head moved {tb.var_moved():.3f} lr; "
            f"{time.perf_counter() - t:.2f} s [{card}]")
        for group, (eg, ed) in errs.items():
            log(f"  {group:20s} grad rel L2 {eg:.3e}, parameter change rel L2 {ed:.3e}")
        if tb.var_moved() < 0.5:
            raise AssertionError(f"train {name}: the var head moved {tb.var_moved():.3f} lr")
    for name, pallas, int8_mlp, n in TRAIN_PLANS:
        if pallas == "0":
            continue
        mine, base = rec[(name, n)], rec[("pallas=0", n)]
        pairs = [("loss", mine["dloss"], base["dloss"])]
        for group in GROUPS:
            pairs += [(f"{group} grad", mine["errs"][group][0], base["errs"][group][0]),
                      (f"{group} change", mine["errs"][group][1], base["errs"][group][1])]
        for what, e, e0 in pairs:
            if not e <= TRAIN_FACTOR * max(e0, TRAIN_FLOOR):
                raise AssertionError(f"train {name} N={n}: {what} error {e:.3e} above "
                                     f"{TRAIN_FACTOR} x pallas '0''s {e0:.3e}")
        worst = max(e / max(e0, TRAIN_FLOOR) for _, e, e0 in pairs)
        log(f"train 13a {name} N={n}: every error within {worst:.2f} x pallas '0''s (bound "
            f"{TRAIN_FACTOR}, floor {TRAIN_FLOOR})")
    return refs, rec


def train_planted(torch, tb: TrainBench, refs: dict, rec: dict, card: str) -> None:
    """13b: four planted faults, each refused by its check."""
    from genconvit_tpu_torch.models import convnext as pc
    from genconvit_tpu_torch.models import vae as vae_mod
    from genconvit_tpu_torch.data.preprocess import normalize_batch
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
    from genconvit_tpu_torch.train import optim

    n, bf = TRAIN_BATCH_SMALL, torch.bfloat16
    # (1) the kernel backbone's folds reused from the step before
    bb = tb.model.ed.backbone
    tb.model.load_state_dict(tb.w0)
    with torch.no_grad():
        ft = bb.feature_tensors()
        stale = pc.kernel_weights(pc.FeatureTensors.unflat(
            ft.layout(), [t.to(bf) for t in ft.flat()]))
    tb.step(bf, make_plan("", "", False), n, lr=TRAIN_FAULT_LR)

    def feature_error() -> float:
        with torch.no_grad():
            ft1 = bb.feature_tensors()
            ts = [t.to(bf) for t in ft1.flat()]
            x = normalize_batch(tb.x[:n], bf)
            out = pc.KernelBackbone.apply(ft1.layout(), "default", "",
                                          (km.ln_mlp_residual, km.layer_norm_rows), x, *ts)
            ref = pc.features_reference(x, pc.FeatureTensors.unflat(ft1.layout(), ts), "default")
            return float((out.float() - ref.float()).norm() / ref.float().norm())

    good = feature_error()
    kw = pc.kernel_weights
    pc.kernel_weights = lambda ft, int8_mlp="": stale
    try:
        bad = feature_error()
    finally:
        pc.kernel_weights = kw
    log(f"train 13b folds of the step before: ED features vs the reference graph after a step "
        f"at lr {TRAIN_FAULT_LR}: rel L2 {good:.3e} with the call's folds, {bad:.3e} with the "
        f"folds reused (limit {FEATURE_TOL}) [{card}]")
    if not (good <= FEATURE_TOL < bad):
        raise AssertionError(f"stale-fold check: good {good}, planted {bad}, limit {FEATURE_TOL}")

    # (2) pallas '1': the LN-folded blocks' folds taken without a graph
    fold_ln = pc.Block.fold_ln
    pc.Block.fold_ln = lambda self: pc.LNFold(*(t.detach() for t in fold_ln(self)))
    try:
        tb.step(bf, make_plan("1", "", False), n)
        bad = tb.errors(refs[n][1])["LN-folded norm+fc1"][0]
    finally:
        pc.Block.fold_ln = fold_ln
    good = rec[("pallas=1", n)]["errs"]["LN-folded norm+fc1"][0]
    log(f"train 13b pallas '1' folds without a graph: LN-folded blocks' norm+fc1 gradient rel L2 "
        f"vs f32 {good:.3e} per call, {bad:.3e} planted (limit {FOLDED_TOL}) [{card}]")
    if not (good <= FOLDED_TOL < bad):
        raise AssertionError(f"folds-without-graph check: good {good}, planted {bad}")

    # (3) missing gradients left None: torch's Adam skips the var head
    fill = optim.fill_missing_grads
    optim.fill_missing_grads = lambda optimizer: None
    try:
        tb.step(bf, make_plan("", "", False), n)
        bad = tb.var_moved()
    finally:
        optim.fill_missing_grads = fill
    good = rec[("default", TRAIN_BATCH)]["var_moved"]
    log(f"train 13b gradients left None: var head moved {good:.3f} lr with zeros filled, "
        f"{bad:.3f} lr planted (limit 0.5) [{card}]")
    if not (good >= 0.5 > bad):
        raise AssertionError(f"missing-gradient check: good {good}, planted {bad}")

    # (4) BN running statistics updated in place under remat (as
    # nn.BatchNorm2d.train() does): the recompute applies the momentum again
    bn_train = vae_mod.batch_norm_train

    def in_place(x, bn, momentum=0.1, eps=1e-5):
        y, (mean, var) = bn_train(x, bn, momentum, eps)
        with torch.no_grad():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
        return y, (bn.running_mean, bn.running_var)

    vae_mod.batch_norm_train = in_place
    try:
        tb.step(torch.float32, make_plan("0", "", False), n)
        bad = tb.bn0_error(n)
    finally:
        vae_mod.batch_norm_train = bn_train
    good = rec[("f32", n)]["bn0"]
    log(f"train 13b BN statistics in place under remat: BN0 running mean off by {good:.2e} "
        f"written back, {bad:.2e} planted (limit {BN_TOL}) [{card}]")
    if not (good <= BN_TOL < bad):
        raise AssertionError(f"in-place BN check: good {good}, planted {bad}")


def train_recompute_share(torch, tb: TrainBench, card: str) -> dict:
    """13d: one bf16 default-plan step at batch 32 with CUDA events around
    each autograd Function's backward (`convnext._reference_vjp`: the plain
    graph recomputed, then differentiated) and around its recompute alone:
    their device time against the step's. A backward kernel could save at
    most the first."""
    from genconvit_tpu_torch.models import convnext as pc

    spans = {"backward": [], "recompute": []}
    vjp = pc._reference_vjp

    def event():
        return torch.cuda.Event(enable_timing=True)

    def timed(graph, x, tensors, g, needs):
        b0, b1, r0, r1 = event(), event(), event(), event()

        def graph_timed(v, ts):
            r0.record()
            out = graph(v, ts)
            r1.record()
            return out

        b0.record()
        grads = vjp(graph_timed, x, tensors, g, needs)
        b1.record()
        spans["backward"].append((b0, b1))
        spans["recompute"].append((r0, r1))
        return grads

    pc._reference_vjp = timed
    try:
        run = tb.trainer(torch.bfloat16, make_plan("", "", False), TRAIN_BATCH)
        run()   # warm-up
        for v in spans.values():
            v.clear()
        t0, t1 = event(), event()
        torch.cuda.synchronize()
        t0.record()
        run()
        t1.record()
        torch.cuda.synchronize()
    finally:
        pc._reference_vjp = vjp
    step = t0.elapsed_time(t1)
    out = {"step_ms": step}
    for k, v in spans.items():
        out[f"{k}_ms"] = sum(a.elapsed_time(b) for a, b in v)
    log(f"train 13d bf16 default plan, N={TRAIN_BATCH}: a step {step:.2f} ms of device time; "
        f"KernelBackbone's backward (3 backbone calls) {out['backward_ms']:.2f} ms "
        f"({100 * out['backward_ms'] / step:.1f}%), of it the plain graph's recompute "
        f"{out['recompute_ms']:.2f} ms ({100 * out['recompute_ms'] / step:.1f}%) [{card}]")
    return out


def train_group(key: str) -> str:
    """A train step's kernel groups of the profile: the scoring path's, with
    Adam's and the GEMMs of the plain graph's backward named."""
    k = key.lower()
    if "multi_tensor_apply" in k or "foreach" in k:
        return "Adam (foreach kernels)"
    name = convnext_group(key)
    if name.startswith("GEMM"):
        return "GEMMs (the plain graph's fc1/fc2 forward and backward, heads)"
    return name


def train_timing(torch, tb: TrainBench, card: str, profile: bool = False) -> dict:
    """13d: TRAIN_STEPS steps on the fixed batch under the default plan (the
    loss must fall), then steps/s and images/s at batch 32 in float32 and
    under bf16 (default plan), median of TIMED_RUNS runs of TIMED_STEPS
    steps, with the peak device memory of each; with profile, the
    profiler's breakdown of a bf16 step by kernel group."""
    import statistics

    losses, _ = tb.step(torch.bfloat16, make_plan("", "", False), TRAIN_BATCH,
                           steps=TRAIN_STEPS)
    log(f"train 13d {TRAIN_STEPS} bf16 steps on one batch of {TRAIN_BATCH}: losses "
        f"{[round(v, 5) for v in losses]} [{card}]")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    out = {"losses": losses, "recompute": train_recompute_share(torch, tb, card)}
    run = None
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        rates = []
        run = None   # the run before's optimizer state goes first
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(tb.dev)
        run = tb.trainer(dtype, make_plan("", "", False), TRAIN_BATCH)
        run()   # warm-up: the optimizer's state is made in its first step
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(TIMED_STEPS):
                run()
            torch.cuda.synchronize()
            rates.append(TIMED_STEPS / (time.perf_counter() - t))
        peak = torch.cuda.max_memory_allocated(tb.dev) / 2**30
        if profile and name == "bf16":
            profile_step(torch, lambda i: run(), train_group,
                         f"[train bf16 default plan N={TRAIN_BATCH}] step", card)
        med = statistics.median(rates)
        out[name] = {"steps_s": med, "images_s": med * TRAIN_BATCH, "spread": (min(rates), max(rates)),
                     "peak_gib": peak}
        log(f"train 13d {name} N={TRAIN_BATCH}: median {med:.3f} steps/s ({med * TRAIN_BATCH:.2f} "
            f"images/s; runs {[round(r, 3) for r in rates]} steps/s, {TIMED_STEPS} steps each "
            f"after a warm-up step, each step's loss fetched), peak device memory {peak:.2f} GiB "
            f"[{card}]")
    return out


def train_cli(torch, np, dev, card: str, tmp: str) -> dict:
    """13e: `python -m genconvit_tpu_torch.train -m genconvit -e 1 -b 8 --bf16`
    in-process over a generated ImageFolder (placeholder files;
    `folder.load_image` substituted by the seeded images in memory,
    `augment.strong_aug` by the identity: this host has no cv2), then
    resumed with -p; the .gcv and .pkl read back; K1 and K2 launches equal
    the steps' and the eval forwards'."""
    import os
    import pickle

    from genconvit_tpu_torch.core.checkpoint import load_checkpoint
    from genconvit_tpu_torch.core.convert import state_dict_from_jax
    from genconvit_tpu_torch.data import augment, folder
    from genconvit_tpu_torch.ops import cuda as kcuda
    from genconvit_tpu_torch.train.__main__ import main as cli_main

    rng = np.random.default_rng(14)
    root, images = os.path.join(tmp, "train_data"), {}
    for split, k in zip(("train", "valid", "test"), CLI_IMAGES):
        for cls in ("fake", "real"):
            os.makedirs(os.path.join(root, split, cls))
            for i in range(k):
                path = os.path.join(root, split, cls, f"{i:02d}.png")
                open(path, "wb").close()
                images[path] = draw_faces(np, rng, 1, IMG, IMG)[0]
    load, aug = folder.load_image, augment.strong_aug
    folder.load_image = lambda path, img_size=None: images[path]
    augment.strong_aug = lambda img, rng: img
    log("train 13e: augmentation is the identity on this host (strong_aug needs cv2; the CPU "
        "tests hold it, tests/test_torch_train_loop.py)")
    wdir = os.path.join(tmp, "train_weights")
    args = ["-d", root, "-m", "genconvit", "-e", "1", "-b", "8", "--bf16", "--weight-dir", wdir]
    out = {}
    try:
        steps, evals = -(-2 * CLI_IMAGES[0] // 8), -(-2 * CLI_IMAGES[1] // 8)
        prev = None
        for run in ("first", "resumed"):
            kcuda.reset_launch_counts()
            t = time.perf_counter()
            summary = cli_main(args + (["-p", prev] if prev else []))
            dt = time.perf_counter() - t
            counts = kcuda.launch_counts()
            want = (108 * steps + 54 * evals, 6 * steps + 3 * evals)
            if (counts["ln_mlp_residual"], counts["layer_norm_rows"]) != want:
                raise AssertionError(f"CLI {run}: launches {counts}, want K1, K2 = {want}")
            t2 = time.perf_counter()
            payload = load_checkpoint(summary["checkpoint"])
            with open(summary["checkpoint"][:-4] + ".pkl", "rb") as f:
                hist = pickle.load(f)
            count = int(payload["opt_state"]["inner_state"]["1"]["count"])
            epoch = payload["epoch"]
            model = summary["model"]
            sd = state_dict_from_jax(payload["params"]["vae"], "vae")
            same = all(torch.equal(sd[k], v.detach().cpu()) for k, v in
                       model.vae.state_dict().items() if k in sd and v.is_floating_point())
            size = os.path.getsize(summary["checkpoint"]) / 2**30
            log(f"train 13e CLI {run}: {dt:.1f} s (K1 {want[0]}, K2 {want[1]} launches: {steps} "
                f"steps, {evals} eval forwards); {summary['checkpoint'].rsplit('/', 1)[-1]} "
                f"{size:.2f} GiB read back in {time.perf_counter() - t2:.1f} s: epoch {epoch}, "
                f"Adam count {count}, VAE weights equal the model's: {same}; history {hist} "
                f"[{card}]")
            want_epoch, want_count = (2, steps) if run == "first" else (4, 2 * steps)
            if not (epoch == want_epoch and count == want_count and same
                    and set(payload["params"]) == {"ed", "vae"}
                    and [len(h) for h in hist] == [1] * 4 and np.all(np.isfinite(hist))):
                raise AssertionError(f"CLI {run}: epoch {epoch}, count {count}, same {same}, "
                                     f"history {hist}")
            out[run] = {"seconds": dt, "gib": size}
            prev = summary["checkpoint"]
            del summary, model, payload, sd
            torch.cuda.empty_cache()
    finally:
        folder.load_image, augment.strong_aug = load, aug
    return out


def phase_train(torch, np, dev, card: str, tmp: str, profile: bool = False) -> dict:
    """Phase 13: training on the card (module docstring)."""
    import gc

    from genconvit_tpu_torch.config import Config

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = time.perf_counter()
        tb = TrainBench(torch, dev, Config())
        log(f"train: convnext_tiny GenConViT, {sum(p.numel() for p in tb.model.parameters())} "
            f"float32 parameters on the card in {time.perf_counter() - t:.1f} s [{card}]")
        refs, rec = train_plan_errors(torch, tb, card)
        train_planted(torch, tb, refs, rec, card)
        del refs
        gc.collect()
        torch.cuda.empty_cache()
        timing = train_timing(torch, tb, card, profile)
        del tb
        gc.collect()
        torch.cuda.empty_cache()
        cli = train_cli(torch, np, dev, card, tmp)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"rec": rec, "timing": timing, "cli": cli}


# ---------------------------------------------------------------- phase 14

P14_V = 4             # the parity batch's videos (phase 5's inputs)
P14_BATCH = TRAIN_BATCH_SMALL   # 14e's training batch
P14_BN_TOL = 0.25     # 14e: a bf16 running mean's distance from the f32 step's, over the f32 change
P14_AUTO = "auto:0.8"


def p14_launches(kcuda, plan, variant: str = "original", sampling: bool = False,
                 net: str = "genconvit") -> dict:
    """The launches of one forward of `net` as the code states them: the
    block tails (K1, or K4 under int8_mlp) of every block of the chosen
    stages ('mlp...'; all others) in each backbone call (the ED's one; the
    VAE's two, or the updated VAE's one 2N call), K2 once a call off
    'mlp...', and K3 for each latent head the VAE runs under int8 heads
    (the updated VAE's var head too when it samples)."""
    calls = (net in ("ed", "genconvit")) + (net in ("vae", "genconvit")) * (
        1 if variant == "updated" else 2)
    stages = plan.mlp_stages()
    want = dict.fromkeys(kcuda.launch_counts(), 0)
    tail = "ln_mlp_residual_int8" if plan.int8_mlp else "ln_mlp_residual"
    want[tail] = calls * sum(DEPTHS[si] for si in (stages if stages is not None else range(4)))
    want["layer_norm_rows"] = calls if stages is None else 0
    if plan.int8_heads:
        want["matmul_wint8"] = 2 if variant == "updated" and sampling else 1
    return want


def p14_config(variant: str = "original"):
    """The published configuration (convnext_tiny, 224 px, latent 12544)
    with the VAE variant."""
    from genconvit_tpu_torch.config import Config, ModelConfig

    return Config(model=ModelConfig(vae_variant=variant))


def p14_params(torch, dev, variant: str = "original", head_act: str = "default",
               seed: int = 14) -> dict:
    """Seeded random float32 weights of a convnext_tiny GenConViT of the
    variant and head, on the card, as phase 5 makes them (layer scale
    U(0.1, 1), both heads' last layer scaled): {'ed', 'vae'} state dicts."""
    from genconvit_tpu_torch.models.convnext import Block
    from genconvit_tpu_torch.models.genconvit import GenConViT
    from genconvit_tpu_torch.models.init import init_genconvit_

    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        model = GenConViT(p14_config(variant), head_act=head_act)
    model = model.to_empty(device=dev)
    init_genconvit_(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Block):
                m.gamma.uniform_(0.1, 1.0, generator=g)
        for branch in model.branches():
            branch.fc2.weight.mul_(LOGIT_SCALE)
            branch.fc2.bias.mul_(LOGIT_SCALE)
    return {b: getattr(model, b).state_dict() for b in ("ed", "vae")}


class P14Case:
    """One set of weights: the float32 plain path's class means on phase
    5's inputs, then each bf16 configuration held against them."""

    def __init__(self, torch, np, dev, card: str, name: str, params: dict):
        from genconvit_tpu_torch.infer.engine import Predictor
        from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

        self.torch, self.np, self.dev, self.card, self.name = torch, np, dev, card, name
        self.params = params
        g = torch.Generator(device=dev).manual_seed(7)
        self.fr = torch.randint(0, 256, (P14_V, FRAMES, IMG, IMG, 3), dtype=torch.uint8,
                                device=dev, generator=g)
        self.mask = torch.ones(P14_V, FRAMES, device=dev)
        self.mask[1, 8:] = 0
        self.mask[3, 2:] = 0
        base = Predictor(p14_config(), net="genconvit", device=dev,
                         params=params, dtype=torch.float32, deterministic_vae=True,
                         kernel_plan=KernelPlan())
        self.variant = base.config.model.vae_variant
        self.heads = (base.model.ed.head_act, base.model.vae.head_act)
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            self.m32 = self.means(base)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        del base
        torch.cuda.empty_cache()
        log(f"p14 [{name}]: {self.variant} VAE, heads ed/vae {self.heads}; f32 plain class "
            f"means {np.round(self.m32, 5).tolist()}")

    def means(self, pred):
        from genconvit_tpu_torch.infer.aggregate import masked_prob_sums

        sums, count = masked_prob_sums(*pred.video_logits(self.fr, self.mask))
        return (sums / count.clamp(min=1)[:, None]).double().cpu().numpy()

    def dy_val(self, m16, m32, what: str, tol: float = YVAL_TOL) -> float:
        """max|dy_val| of class means m16 against m32 (<= tol), and y equal
        wherever m32's class means differ by more than twice tol."""
        np = self.np

        def verdicts(m):
            return m.argmax(-1), np.where(m[:, 0] > m[:, 1], m[:, 0], np.abs(1 - m[:, 1]))

        (y16, v16), (y32, v32) = verdicts(m16), verdicts(m32)
        dyv = float(np.abs(v16 - v32).max())
        decisive = np.abs(m32[:, 0] - m32[:, 1]) > 2 * tol
        log(f"  {what}: max|dy_val| = {dyv:.3e} (limit {tol}); decisive videos "
            f"{int(decisive.sum())}/{len(m32)}, y {y16.tolist()} ref {y32.tolist()} [{self.card}]")
        if not dyv <= tol:
            raise AssertionError(f"p14 [{self.name}] {what}: max|dy_val| {dyv} > {tol}")
        if not decisive.any():
            raise AssertionError(f"p14 [{self.name}] {what}: no decisive video")
        if not (y16[decisive] == y32[decisive]).all():
            raise AssertionError(f"p14 [{self.name}] {what}: y differs on a decisive video")
        return dyv

    def run(self, label: str, plan, parity: bool = True, rate: bool = False,
            profile: bool = False) -> dict:
        """A bf16 Predictor of `plan` on these weights: the launches of one
        forward deterministic and one sampling, each equal to p14_launches';
        the class means (held against float32 unless parity is False);
        V=8 videos/s when rate; the profiler's breakdown of a V=8 forward
        when profile."""
        from genconvit_tpu_torch.infer.engine import Predictor
        from genconvit_tpu_torch.ops import cuda as kcuda

        torch = self.torch
        t = time.perf_counter()
        pred = Predictor(p14_config(), net="genconvit", device=self.dev,
                         params=self.params, deterministic_vae=True, kernel_plan=plan)
        built = time.perf_counter() - t
        rec = {"plan": plan, "stats": pred.dw_sep_stats}
        for sampling in (False, True):
            pred.deterministic_vae = not sampling
            kcuda.reset_launch_counts()
            m = self.means(pred)
            got = kcuda.launch_counts()
            want = p14_launches(kcuda, plan, self.variant, sampling)
            if got != want:
                raise AssertionError(f"p14 [{self.name}, {label}] sampling={sampling}: launches "
                                     f"{got}, want {want}")
            if not sampling:
                rec["means"] = m
        rec["launches"] = {k: v for k, v in got.items() if v}
        stats = "" if rec["stats"] is None else (
            f"; dw_rank {plan.dw_rank}: {int(rec['stats']['blocks_sep'])} blocks separable "
            f"(rank mix {rec['stats']['rank_hist']}), {int(rec['stats']['blocks_exact'])} "
            f"exact, retained SVD energy mean {rec['stats']['energy_mean']:.4f} min "
            f"{rec['stats']['energy_min']:.4f}")
        log(f"p14 [{self.name}, {label}]: Predictor {built:.2f} s, launches a forward "
            f"{rec['launches']} (sampling; the same less K3's var head deterministic){stats}")
        if parity:
            rec["dy_val"] = self.dy_val(rec["means"], self.m32, f"{label} vs f32 plain",
                                        YVAL_TOL_INT8 if plan.int8_mlp else YVAL_TOL)
        else:
            rec["dy_val"] = float(self.np.abs(rec["means"] - self.m32).max())
            log(f"  {label}: max|class mean - f32's| = {rec['dy_val']:.3e} (an approximation: "
                f"no limit) [{self.card}]")
        if rate:
            rec.update(phase_throughput(torch, pred, self.dev, self.card,
                                        f"p14 {self.name}, {label}", v1=False))
        if profile:
            phase_profile(torch, pred, self.dev, self.card, f"p14 {self.name}, {label}")
        del pred
        torch.cuda.empty_cache()
        return rec


def p14_refusals(torch, dev) -> None:
    """dw_rank with pallas '1' and 'stage': the Predictor refuses the plan."""
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

    for pallas in ("1", "stage"):
        try:
            Predictor(p14_config(), device=dev, kernel_plan=KernelPlan(pallas=pallas, dw_rank=1))
        except ValueError as e:
            log(f"p14 refusal: dw_rank=1 with pallas={pallas!r} raised ValueError ({str(e)[:60]}...)")
            continue
        raise AssertionError(f"dw_rank=1 with pallas={pallas!r} was not refused")


def p14_train(torch, dev, card: str) -> dict:
    """14e: one bf16 step of the updated VAE ('vae' net, default plan) and
    of genconvit under 'mlp:0,1', each against the float32 step of the
    batch beside pallas '0''s bf16 step (phase 13a's bar); the updated
    step's 7 BatchNorm running means written back."""
    import gc

    from genconvit_tpu_torch.ops import cuda as kcuda
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

    out = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, net, variant, plan in (
                ("updated vae", "vae", "updated", KernelPlan()),
                ("genconvit mlp:0,1", "genconvit", "original", KernelPlan(pallas="mlp:0,1"))):
            t = time.perf_counter()
            tb = TrainBench(torch, dev, p14_config(variant), net)
            vae = tb.model.vae
            bns = [vae.encoder.features[3 * i + 1] for i in range(4)]
            if vae.updated:
                bns += [vae.decoder.features[3 * i + 1] for i in range(3)]
            old = [bn.running_mean.detach().clone() for bn in bns]
            losses, counts = tb.step(torch.float32, KernelPlan(pallas="0"), P14_BATCH)
            ref = (losses[0], tb.snapshot())
            rm32 = [bn.running_mean.detach().clone() for bn in bns]
            if any(counts.values()):
                raise AssertionError(f"p14 train {name} f32: launches {counts}")
            errs = {}
            for label, p in (("pallas=0", KernelPlan(pallas="0")), ("kernels", plan)):
                losses, counts = tb.step(torch.bfloat16, p, P14_BATCH)
                want = dict.fromkeys(counts, 0)
                if p.pallas != "0":
                    want = {k: 2 * v for k, v in p14_launches(kcuda, p, variant,
                                                               net=net).items()}
                if counts != want:
                    raise AssertionError(f"p14 train {name} {label}: launches {counts}, want {want}")
                e = tb.errors(ref[1])
                errs[label] = dict({g: v for g, v in e.items()},
                                   loss=abs(losses[0] - ref[0]) / abs(ref[0]))
                shown = {k: v for k, v in counts.items() if v}
                log(f"p14 train [{name}] {label} bf16 N={P14_BATCH}: loss {losses[0]:.6f} (f32 "
                    f"{ref[0]:.6f}, rel {errs[label]['loss']:.2e}); launches a step {shown} [{card}]")
                for group, (eg, ed) in e.items():
                    log(f"  {group:20s} grad rel L2 {eg:.3e}, parameter change rel L2 {ed:.3e}")
            mine, base = errs["kernels"], errs["pallas=0"]
            pairs = [("loss", mine["loss"], base["loss"])]
            for group in tb.groups:
                pairs += [(f"{group} grad", mine[group][0], base[group][0]),
                          (f"{group} change", mine[group][1], base[group][1])]
            for what, e, e0 in pairs:
                if not e <= TRAIN_FACTOR * max(e0, TRAIN_FLOOR):
                    raise AssertionError(f"p14 train {name}: {what} error {e:.3e} above "
                                         f"{TRAIN_FACTOR} x pallas '0''s {e0:.3e}")
            worst = max(e / max(e0, TRAIN_FLOOR) for _, e, e0 in pairs)
            # the running means after the kernel step, against the float32 step's
            moved = []
            for i, (bn, o, r) in enumerate(zip(bns, old, rm32)):
                rm = bn.running_mean.detach()
                d32 = float((r - o).abs().max())
                dev16 = float((rm.float() - r.float()).abs().max()) / max(d32, 1e-30)
                if not (torch.isfinite(rm).all() and float((rm - o).abs().max()) > 0
                        and dev16 <= P14_BN_TOL):
                    raise AssertionError(f"p14 train {name}: BN {i} running mean not written "
                                         f"back (f32 change {d32:.3e}, bf16 off by {dev16:.3e})")
                moved.append(dev16)
            log(f"p14 train [{name}]: every error within {worst:.2f} x pallas '0''s (bound "
                f"{TRAIN_FACTOR}, floor {TRAIN_FLOOR}); {len(bns)} BN running means written back, "
                f"off the f32 step's by {max(moved):.3e} of its change at most; "
                f"{time.perf_counter() - t:.1f} s [{card}]")
            out[name] = {"errs": errs, "worst": worst, "bn": len(bns), "bn_dev": max(moved)}
            del tb
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def phase_p14(torch, np, dev, card: str, profile: bool = False) -> dict:
    """Phase 14 (module docstring): returns each configuration's record.
    profile: the breakdown of a V=8 forward of the updated VAE, dw_rank=1,
    'mlp:0,1' and 'mlp' too."""
    import gc

    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

    out = {}

    def case(name, params):
        c = P14Case(torch, np, dev, card, name, params)
        del params
        return c

    # (a) the updated VAE
    c = case("updated", p14_params(torch, dev, "updated"))
    if c.variant != "updated":
        raise AssertionError(f"the Predictor built a {c.variant} VAE from updated weights")
    out["updated"] = c.run("default", KernelPlan(), rate=True, profile=profile)
    out["updated+int8_heads"] = c.run("int8_heads", KernelPlan(int8_heads=True), rate=True)
    del c
    gc.collect()
    torch.cuda.empty_cache()
    # (b) SwiGLU heads
    c = case("swiglu", p14_params(torch, dev, head_act="swiglu"))
    if c.heads != ("swiglu", "swiglu"):
        raise AssertionError(f"the Predictor built heads {c.heads} from SwiGLU weights")
    out["swiglu"] = c.run("default", KernelPlan())
    del c
    gc.collect()
    torch.cuda.empty_cache()
    # (c) dw_rank and (d) the plan values, on the default model's weights
    c = case("default", p14_params(torch, dev))
    exact = c.run("exact", KernelPlan())
    r7 = c.run("dw_rank=7", KernelPlan(dw_rank=7))
    r7["dy_exact"] = c.dy_val(r7["means"], exact["means"], "dw_rank=7 vs the exact bf16 default")
    out["dw_rank=7"] = r7
    out["dw_rank=1"] = c.run("dw_rank=1", KernelPlan(dw_rank=1), parity=False, rate=True,
                             profile=profile)
    out[f"dw_rank={P14_AUTO}"] = c.run(f"dw_rank={P14_AUTO}", KernelPlan(dw_rank=P14_AUTO),
                                       parity=False)
    out["dw_rank=1+fc1"] = c.run("dw_rank=1, int8_mlp=fc1", KernelPlan(dw_rank=1, int8_mlp="fc1"),
                                 parity=False)
    p14_refusals(torch, dev)
    for pallas in ("mlp:0,1", "mlp", "mlpfull"):
        out[pallas] = c.run(f"pallas={pallas}", KernelPlan(pallas=pallas), rate=True,
                            profile=profile and pallas != "mlpfull")
    del c
    gc.collect()
    torch.cuda.empty_cache()
    # (e) training
    out["train"] = p14_train(torch, dev, card)
    return out


def p14_summary(p14: dict, card: str) -> None:
    for name, r in p14.items():
        if name == "train":
            continue
        rate = (f"V=8 {r['v8_videos_s']:.2f} videos/s ({r['v8_ms']:.2f} ms/launch), "
                if "v8_videos_s" in r else "")
        log(f"summary [p14 {name}]: {rate}launches a forward {r['launches']}; "
            f"max|dy_val| (or class-mean distance) vs f32 plain {r['dy_val']:.3e} [{card}]")
    for name, r in p14["train"].items():
        log(f"summary [p14 train {name}]: worst error {r['worst']:.2f} x pallas '0''s; "
            f"{r['bn']} BN running means written back [{card}]")


def main() -> int:
    import argparse
    import gc
    import tempfile

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 7, the profiler's device-time breakdowns (and a train step's, "
                         "and phase 14's)")
    ap.add_argument("--train-only", action="store_true",
                    help="phases 1, 2 and 13 alone (no result lines): for work on training")
    ap.add_argument("--phase14-only", action="store_true",
                    help="phases 1, 2 and 14 alone (no result lines): the updated VAE, the "
                         "SwiGLU heads, dw_rank and the 'mlp' plan values")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from genconvit_tpu_torch.ops.cuda import _build
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
    from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = phase_identity()
    info = _build.build()
    log(f"build: {info.seconds:.1f} s -> {info.path}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    for c in sorted({c for c in DIMS} | {c for _, _, c in K1_WIDE}):
        plan, lib = km.mlp_plan(c), km.library_plan(c)
        if plan != lib:
            raise AssertionError(f"K1's plan mirror at C={c}: {plan}, the library's {lib}")
        log(f"K1 plan C={c}: {tuple(plan)} (rows, group columns, stages, shared bytes), "
            f"{plan.passes(c)} pass(es){', streamed' if plan.streams(c) else ', in turns'}")
        for mode in k4.MODES:
            plan, lib = k4.k4_plan(c, mode), k4.library_plan(c, mode)
            if plan != lib:
                raise AssertionError(f"K4's plan mirror at C={c} ({mode}): {plan}, the "
                                     f"library's {lib}")
            log(f"K4 plan C={c} {mode}: {tuple(plan)} (rows, group columns, w1t tiles a "
                f"stage, stages, shared bytes), {plan.passes(c)} pass(es)")
    if args.train_only:
        with tempfile.TemporaryDirectory(prefix="gcv_train_") as tmp:
            t = time.perf_counter()
            phase_train(torch, np, dev, card, tmp, args.profile)
            log(f"phase 13: {time.perf_counter() - t:.1f} s")
        log(f"chip_smoke --train-only: phase 13 passed in {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.phase14_only:
        t = time.perf_counter()
        p14_summary(phase_p14(torch, np, dev, card, args.profile), card)
        log(f"phase 14: {time.perf_counter() - t:.1f} s")
        log(f"chip_smoke --phase14-only: phase 14 passed in {time.perf_counter() - t_all:.1f} s")
        return 0
    t = time.perf_counter()
    kernels = (phase_kernels(torch, dev, card) + phase_fused(torch, dev, card)
               + [phase_k7(torch, dev, card)])
    log(f"phase 3: {time.perf_counter() - t:.1f} s")
    runs = {}
    for cfg in CONFIGS:
        t = time.perf_counter()
        pred, totals, peak = phase_slice(torch, np, dev, card, cfg)
        runs[cfg[0]] = dict(phase_throughput(torch, pred, dev, card, cfg[0]),
                            launches=totals, peak_forward_gib=peak)
        if args.profile and cfg[0] in PROFILED:
            phase_profile(torch, pred, dev, card, cfg[0])
        del pred
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phases 4 and 6 [{cfg[0]}]: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    parity = phase_parity(torch, np, dev, card)
    log(f"phase 5: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    large = phase_large(torch, np, dev, card, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 10: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    swin = phase_swin(torch, dev, card, args.profile)
    log(f"phase 8: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    probe_recs, probe_counts = phase_probes(torch, dev, card, info.path)
    kernels += probe_recs
    log(f"phase 9: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gcv_video_") as tmp:
        video = phase_video(torch, np, dev, card, tmp)
        log(f"phase 11: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        serving = phase_serve(torch, np, dev, card, tmp, video.pop("corpus"))
        log(f"phase 12: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        p14 = phase_p14(torch, np, dev, card, args.profile)
        log(f"phase 14: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        training = phase_train(torch, np, dev, card, tmp, args.profile)
        log(f"phase 13: {time.perf_counter() - t:.1f} s")
    for name, r in runs.items():
        log(f"summary [{name}]: V=8 {r['v8_videos_s']:.2f} videos/s ({r['v8_ms']:.2f} "
            f"ms/launch), V=1 {r['v1_ms']:.2f} ms/launch (synchronized median "
            f"{r['v1_sync_median_ms']:.2f} ms), peak device memory {r['peak_forward_gib']:.2f} "
            f"GiB over phase 4's forwards, {r['peak_v8_gib']:.2f} GiB at V=8; "
            f"max|dy_val| vs f32 plain {parity[name]:.3e} [{card}]")
    for name, r in large.items():
        v1 = "not measured" if r["v1_ms"] is None else f"{r['v1_ms']:.2f} ms/launch"
        log(f"summary [{name}, {LARGE}]: V=8 {r['v8_videos_s']:.2f} videos/s "
            f"({r['v8_ms']:.2f} ms/launch), V=1 {v1}, peak device "
            f"memory {r['peak_v8_gib']:.2f} GiB at V=8; launches {r['launches']}; "
            f"max|dy_val| vs f32 plain {r['dy_val']:.3e} [{card}]")
    for (pname, n), (rate, ms, peak) in swin["rates"].items():
        log(f"summary [swin_tiny {pname}] N={n}: {rate:.2f} images/s ({ms:.3f} ms/forward), "
            f"peak device memory {peak:.2f} GiB [{card}]")
    log(f"summary [video path]: predict_files 'jax' median {video['videos_s']:.2f} videos/s "
        f"(min {video['spread'][0]:.2f}, max {video['spread'][1]:.2f}) over {TIMED_RUNS} runs of "
        f"{8 * TIMED_COPIES} videos at video_batch={VIDEO_BATCH}, peak device memory "
        f"{video['peak_gib']:.2f} GiB [{card}]")
    for mode, r in serving["modes"].items():
        log(f"summary [serve {mode}]: {r['rps']:.2f} requests/s, p50 {r['p50_ms']:.1f} ms, p95 "
            f"{r['p95_ms']:.1f} ms, {r['launches']} device launches ({r['per_launch']:.2f} videos a "
            f"launch) over {8 * SERVE_COPIES} requests at concurrency {SERVE_CONCURRENCY} [{card}]")
    st = serving["stream"]
    log(f"summary [stream]: {STREAM_BATCHES} V=8 batches {min(st['stream']):.2f} ms (best of "
        f"{len(st['stream'])}) against {min(st['sequential']):.2f} ms one predict_videos_batched "
        f"call after another; peak device memory over phase 12 {serving['peak_gib']:.2f} GiB [{card}]")
    for name in ("f32", "bf16"):
        r = training["timing"][name]
        log(f"summary [train {name}]: genconvit, convnext_tiny, 224 px, batch {TRAIN_BATCH}: "
            f"median {r['steps_s']:.3f} steps/s ({r['images_s']:.2f} images/s, runs "
            f"{r['spread'][0]:.3f}-{r['spread'][1]:.3f} steps/s), peak device memory "
            f"{r['peak_gib']:.2f} GiB [{card}]")
    for (name, n), r in training["rec"].items():
        if name != "f32":
            log(f"summary [train 13a {name} N={n}]: loss rel {r['dloss']:.2e}; grad rel L2 ed "
                f"{r['errs']['ed'][0]:.3e}, vae {r['errs']['vae'][0]:.3e}; launches a step "
                f"{ {k: v for k, v in r['counts'].items() if v} } [{card}]")
    p14_summary(p14, card)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_all:.1f} s [{card}]")
    # each kernel's launches: the count of the run whose main path runs it
    # (the counts were set to 0 just before its requests)
    source_run = {"ln_mlp_residual": "default", "layer_norm_rows": "default",
                  "matmul_wint8": "int8_heads",
                  "ln_mlp_residual_int8[fc1]": "int8_mlp=fc1",
                  "ln_mlp_residual_int8[full]": "int8_heads+full",
                  "fused_convnext_block": "pallas=1", "fused_convnext_stage": "pallas=stage",
                  "window_attention": "swin", "dots_bf16": "probes", "dots_int8": "probes",
                  "block_parts": "probes", "dw_moments": "probes"}
    counts = {name: r["launches"] for name, r in runs.items()}
    counts["swin"] = swin["launches"]
    counts["probes"] = probe_counts
    for k in kernels:
        k["launches"] = counts[source_run[k["name"]]][k["name"].split("[")[0]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
