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
     (it runs after phase 12 and before phase 15; `--phase14-only` runs
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

  15. the fullframe fast paths' device half (it runs after phase 14 and
     before phase 13; `--phase15-only` runs phases 1, 2 and 15 alone):
     convnext_tiny GenConViT at full width and depth, 224 px, latent 12544,
     15 frames, seeded weights as phase 14 makes them (heads scaled),
     deterministic VAE, TF32 off for the float32 references. (a)
     `normalize_yuv420` on the card on seeded [120,224,224] / [120,112,112]
     planes with per-video [8,3,4] affines mixing bt601/bt709 and
     full/limited range, against the port's CPU float32 version: max|diff|
     <= 1e-5 after normalization; planted faults (U and V swapped, chroma
     shifted one row, the range offset dropped) must fail; its time beside
     `normalize_batch` on RGB frames; (b) `forward_batched_yuv` at V=8 in
     the default plan (54 K1 + 3 K2 a forward) and under int8 heads +
     'full' (54 K4 + 3 K2 + 1 K3) against the float32 plain path on the same
     planes: max|dy_val| <= 2e-2 (4e-2 with the int8 tails), equal y on
     decisive videos; V=8 videos/s by phase 6's protocol beside the RGB
     `forward_batched`'s; (c) `predict_videos_stream_yuv` over four V=8
     host batches equal to `forward_batched_yuv` on each, bit for bit, timed
     against `predict_videos_stream` on the RGB frames of the same videos;
     (d) with `data.native`'s `native_available`, `NativeVideoReader` and
     `decode_videos_batch` swapped for an in-memory source of 16 videos at
     224 px (one unreadable, one without frames; put back after),
     `predict_files` under transfer_format 'rgb' (`predict_files_native_rgb`,
     groups of 8) and 'yuv420' (`predict_files_yuv`, groups of 16), three
     runs each: every verdict within 2e-3 of `forward_batched` /
     `forward_batched_yuv` on the same frames or planes, y equal where
     decisive, the unreadable video None (yuv420) or (0, 0.5) (rgb: count
     0), the empty one (0, 0.5), 54 K1 + 3 K2 per group forward, videos/s;
     `extract_faces` of one path bit for bit the source's frames and
     `predict_video` 54 + 3; (e) `prediction.main` in-process over
     placeholder files with `--face-backend fullframe --transfer-format
     yuv420` (its Predictor given the phase's weights): the JAX package's
     result keys, one group forward, the verdicts of (d).

  16. data parallelism on torch.distributed (it runs after phase 15 and
     before phase 13; `--phase16-only` runs phases 1, 2 and 16 alone):
     convnext_tiny GenConViT at full width and depth, 224 px, the bf16
     default plan, seeded weights as phase 14 makes them (heads scaled),
     deterministic VAE. (a) NCCL, world 1, in this process:
     `parallel.eval_shard.predict_sharded` on V=8 (15 frames) bit-equal to
     `forward_batched`, `predict_long_video` on 60 frames (the last 7
     masked) within 1e-6 of `forward_batched` on [1, 60], 54 K1 + 3 K2 a
     forward, V=8 videos/s of predict_sharded beside forward_batched in
     turns; (b) two ranks spawned on the card (`parallel.dryrun.Ranks`),
     gloo on CUDA tensors, each loading 16a's weights from a temporary file:
     predict_sharded (4 videos a rank) y equal to and y_val within 5e-4 of
     16a's forward_batched on each rank's block of 4, the long video (30
     frames a rank) within 5e-4 of 16a's sums over the two halves, both
     within 2e-2 of the whole-batch forwards (the bf16 batch effect alone
     moves them: 16a reads it in one process), 54 K1 + 3 K2 a forward on
     each rank; one float32 data-parallel train step at global
     batch 16 (TF32 off) against the one-process step on rank 0: loss within
     1e-4 relative, parameter change within 1e-3 relative L2; one bf16 step
     in the default plan (108 K1 + 6 K2 a rank) within 1e-2 of the
     one-process bf16 step's loss; planted faults caught: the gather's rank
     order rotated, each rank's own BatchNorm statistics. Two ranks on one
     card are time-sliced: their times are no scaling numbers.

  17. tensor parallelism (it runs after phase 16 and before phase 13;
     `--phase17-only` runs phases 1, 2 and 17 alone): two gloo ranks
     spawned on the card (`parallel.dryrun.Ranks`) on a 1x2 ('data',
     'model') mesh; convnext_tiny GenConViT at full width and depth, 224 px,
     15 frames, seeded weights as phase 14 makes them (heads scaled by 30),
     deterministic VAE, each rank's one-process references on its own
     predictors. (a) `predict_sharded(..., tensor_parallel=True)` on V=8
     under the default plan: no kernel launched (the JAX package's rule:
     pallas '' takes the plain graph on a split backbone), y equal where
     decisive and y_val within 2e-2 of the one-process forward under
     pallas '0' and under the default plan; (b) int8 heads: K3 on each
     rank's 6272-column shard of the latent heads against
     `matmul_wint8_plain` at M = 120 and 240 (bias dropped: refused), K3's
     launches a rank equal to the one-process count, y_val within 2e-2;
     after the ranks, K3 at N = 6272 timed in this process alone beside its
     plain version, F.linear on the bf16 block and the bound (a record of
     the kernels' line); (c) pallas 'stage' and 'mlpfull' (the kernels on
     whole weights, gathered once): launches a rank equal to the one-process
     ones, y_val within 5e-3 of the one-process forward of the plan (the
     split products round differently from the unsplit ones: the bf16
     noise, read beside as the one-process V=8 forward against its two
     blocks of 4); (d)
     one float32 DP+TP train step at batch 16 (TF32 off) against the
     one-process step (each rank takes its turn): loss within 1e-5
     relative, each group of split parameters' gradients (mlp.fc1,
     mlp.fc2, head.fc, fc, fc2, the latent heads) and the replicated ones
     within 1e-4 relative L2, the parameter change within 1e-3, the
     replicated parameters bit-equal across the ranks; (e) planted faults
     caught: a SwiGLU fc split contiguously (SwiGLU heads against pallas
     '0', where the right split holds 5e-3), fc2's bias added on every
     rank, all_reduce_sum in place of reduce_from_model (the gradients);
     peak device memory a rank. Time-sliced on one card: no scaling number.

  18. the last JAX modules (it runs after phase 17 and before phase 13;
     `--phase18-only` runs phases 1, 2 and 18 alone): (a) the on-card
     parity sweep (`tools/onchip_parity.py`): every fast path held against
     the unfused bf16 graph it replaces (`block_reference`), not against
     its plain version: the LN-folded block, K1, K1 through stage_mlp, K4
     in both modes, K5 and K6 where their rules apply at the four
     convnext_tiny stage shapes (3e-2; int8 4e-2), K7 plain and shifted
     against the float32 attention (3e-2), the rational GELU against exact
     erf (1e-2), K2 against F.layer_norm and K3 on the 25088 x 12544 head
     against the float32 product with the dequantized weight; then the
     sweep with each of its planted faults (onchip_parity.PLANTS), each of
     which must fail it; each kernel's max rel diff against the unfused
     graph, and the kernels' launches in the sweep (one per check); (b)
     `synth_dataset` over seeded faces and frames in memory (the skin weak
     labels; cv2 must not be imported), `train_facedet_synth.train` on the card
     (256 samples, 2 epochs at batch 64): finite epoch losses, evaluate,
     the `.gcv` written and read back equal by the port's loader, the
     committed genconvit_tpu/assets/facedet.gcv byte-identical before and
     after; (c) the published configuration's `model_summary` TOTAL equal
     to its parameters plus its BatchNorm running statistics (the JAX
     tree holds those too).

  19. the weight converter CLI and the A/B runner (it runs after phase 18
     and before phase 13; `--phase19-only` runs phases 1, 2 and 19 alone):
     (a) seeded reference-keyed `.pth` files of the published configuration
     with every dead group (`convert_weights.published_layout`: a whole
     swin_tiny embedder with timm's buffers, the HybridEmbed's second
     registration of it and its proj, the VAE's encoder.fc1/fc2 and fc3),
     the ED bare, the VAE nested under 'state_dict'; (b) `python -m
     genconvit_tpu_torch.convert_weights` as subprocesses, all at once:
     --strict with and without --no-dead on both files, --preflight
     --expect-init on both files' manifests (exit 0; the VAE's with
     --no-dead too) and on one whose latent heads drifted (exit 1, the heads
     named); (c) the carrying `.gcv`, the --no-dead one and the `.pth` give
     the written tensors (the dead groups in the carrying tree only), and
     Predictors from the `.gcv`'s and the `.pth`'s weights score one V=8
     batch with equal y_val under the default plan (54 K1 + 3 K2 launches)
     and under int8 heads (+ 1 K3); (d) `run_benchmark.main` in-process over
     placeholder files of phase 11's corpus with phase 12's in-memory
     decoder, the `.gcv` weights by name and the 'jax' detector: both result
     JSONs, the same labels, preds within 1e-5; the comparison where
     matplotlib is installed, else its ImportError after both runs.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Optional

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


def seeded_weights(torch, dev, seed: int) -> dict:
    """{'ed', 'vae'}: the published configuration's state dicts on the host,
    made on the card from a seed: the port's init, layer scale U(0.1, 1)
    and both heads' last layer scaled by LOGIT_SCALE (as in phase 5), so
    that verdicts are decisive."""
    from genconvit_tpu_torch.models.convnext import Block
    from genconvit_tpu_torch.models.genconvit import GenConViT
    from genconvit_tpu_torch.models.init import init_genconvit_

    g = torch.Generator(device=dev).manual_seed(seed)
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
    return sd


def video_weights(torch, dev, wdir: str) -> dict:
    """11a: seeded random ED and VAE weights (layer scale and heads as in
    phase 5, so that verdicts are decisive) written through the port's
    writers: the ED as a `.gcv` nested under 'ed' (train_model's layout),
    the VAE as a reference-keyed `.pth` nested under 'state_dict' with the
    dead groups added."""
    import os

    from genconvit_tpu_torch.core.checkpoint import MAX_CHUNK_SIZE, save_checkpoint
    from genconvit_tpu_torch.core.convert import tree_from_state_dict

    sd = seeded_weights(torch, dev, 11)
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


def memory_decoder(corpus: dict, aliases: Optional[dict] = None):
    """`engine.extract_frames`' stand-in: a placeholder file (or request
    body) holds the name of a corpus video, or an alias of one; any other
    name raises as an undecodable video does."""
    aliases = aliases or {}

    def in_memory(path, num_frames, prefer_native=True):
        with open(path, "rb") as f:
            name = f.read().decode("utf-8", "replace")
        name = aliases.get(name, name)
        if name not in corpus:
            raise IOError(f"cannot open video: {name[:40]!r}")
        return corpus[name][:num_frames]

    return in_memory


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
    decode = engine.extract_frames
    engine.extract_frames = memory_decoder(corpus, aliases)
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
    pc.Block.fold_ln = lambda self, tp=None: pc.LNFold(*(t.detach() for t in fold_ln(self, tp)))
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

    def in_place(x, bn, momentum=0.1, eps=1e-5, group=None):
        y, (mean, var) = bn_train(x, bn, momentum, eps, group)
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


def verdict_parity(np, card: str, tag: str, m16, m32, what: str, tol: float) -> float:
    """max|dy_val| of class means m16 against m32 (<= tol), and y equal
    wherever m32's class means differ by more than twice tol."""

    def verdicts(m):
        return m.argmax(-1), np.where(m[:, 0] > m[:, 1], m[:, 0], np.abs(1 - m[:, 1]))

    (y16, v16), (y32, v32) = verdicts(m16), verdicts(m32)
    dyv = float(np.abs(v16 - v32).max())
    decisive = np.abs(m32[:, 0] - m32[:, 1]) > 2 * tol
    log(f"  {what}: max|dy_val| = {dyv:.3e} (limit {tol}); decisive videos "
        f"{int(decisive.sum())}/{len(m32)}, y {y16.tolist()} ref {y32.tolist()} [{card}]")
    if not dyv <= tol:
        raise AssertionError(f"{tag} {what}: max|dy_val| {dyv} > {tol}")
    if not decisive.any():
        raise AssertionError(f"{tag} {what}: no decisive video")
    if not (y16[decisive] == y32[decisive]).all():
        raise AssertionError(f"{tag} {what}: y differs on a decisive video")
    return dyv


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
        return verdict_parity(self.np, self.card, f"p14 {self.name}", m16, m32, what, tol)

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


# ---------------------------------------------------------------- phase 15

P15_V = 8             # the YUV forward's and the stream's batch
P15_NORM_TOL = 1e-5   # 15a: normalize_yuv420 on the card vs the CPU, after normalization
P15_DRIVER_TOL = 2e-3  # 15d: a driver's verdict vs forward_batched(_yuv) on the same video:
                       # the same bf16 path, only the batch differs (RECORDED_TOL's bound)
P15_COLORS = (("bt601", False), ("bt709", True), ("bt709", False), ("bt601", True))
P15_VIDEOS = 16       # 15d: the drivers' corpus (one unreadable, one without frames)
P15_UNREADABLE = "p15_03.mp4"
P15_EMPTY = "p15_11.mp4"


def p15_planes(np, rng, v: int, f: int = FRAMES, s: int = IMG) -> tuple:
    """Seeded uint8 planes y [v,f,s,s], u and v [v,f,s/2,s/2] and one [3,4]
    affine a video, mixing bt601/bt709 and full/limited range."""
    from genconvit_tpu_torch.data.preprocess import yuv_affine

    y = rng.integers(0, 256, (v, f, s, s), np.uint8)
    u = rng.integers(0, 256, (v, f, s // 2, s // 2), np.uint8)
    w = rng.integers(0, 256, (v, f, s // 2, s // 2), np.uint8)
    m = np.stack([yuv_affine(*P15_COLORS[i % len(P15_COLORS)]) for i in range(v)])
    return y, u, w, m


def p15_conversion(torch, np, dev, card: str) -> dict:
    """15a: normalize_yuv420 on the card against the port's CPU float32
    version on the same planes; the planted faults must fail."""
    from genconvit_tpu_torch.data.preprocess import normalize_batch, normalize_yuv420

    rng = np.random.default_rng(15)
    y, u, w, m = p15_planes(np, rng, P15_V)
    n = P15_V * FRAMES
    host = [torch.from_numpy(a.reshape((n,) + a.shape[2:])) for a in (y, u, w)]
    mats = torch.from_numpy(np.repeat(m, FRAMES, axis=0))
    ref = normalize_yuv420(*host, mats)
    yd, ud, wd = (t.to(dev) for t in host)
    md = mats.to(dev)

    def err(*args) -> float:
        out = normalize_yuv420(*args)
        if not out.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError("normalize_yuv420 on the card is not channels_last")
        return float((out.cpu() - ref).abs().max())

    e = err(yd, ud, wd, md)
    if not e <= P15_NORM_TOL:
        raise AssertionError(f"normalize_yuv420 card vs CPU: max|diff| {e} > {P15_NORM_TOL}")
    no_offset = md.clone()
    no_offset[:, :, 3] = 0
    planted = {"U and V swapped": err(yd, wd, ud, md),
               "chroma one row down": err(yd, ud.roll(1, 1), wd.roll(1, 1), md),
               "range offset dropped": err(yd, ud, wd, no_offset)}
    for what, pe in planted.items():
        if not pe > P15_NORM_TOL:
            raise AssertionError(f"15a planted fault '{what}' passed: {pe} <= {P15_NORM_TOL}")
    rgb = torch.randint(0, 256, (n, IMG, IMG, 3), dtype=torch.uint8, device=dev)
    ms_yuv = cuda_ms(torch, lambda: normalize_yuv420(yd, ud, wd, md, torch.bfloat16), 20)
    ms_rgb = cuda_ms(torch, lambda: normalize_batch(rgb, torch.bfloat16), 20)
    log(f"p15 [conversion]: normalize_yuv420 on [{n},{IMG},{IMG}] planes, 8 per-video [3,4] "
        f"affines (bt601/bt709, limited/full), card vs CPU float32 max|diff| {e:.3e} (limit "
        f"{P15_NORM_TOL}); planted faults refused: "
        + ", ".join(f"{k} {v:.3e}" for k, v in planted.items())
        + f"; bf16 out {ms_yuv:.4f} ms against normalize_batch on the RGB frames "
        f"{ms_rgb:.4f} ms [{card}]")
    return {"err": e, "planted": planted, "ms_yuv": ms_yuv, "ms_rgb": ms_rgb}


def p15_yuv_means(torch, np, pred, planes: tuple, mask) -> "np.ndarray":
    """Per-video class means of video_logits_yuv (phase 5's readout)."""
    from genconvit_tpu_torch.infer.aggregate import masked_prob_sums

    sums, count = masked_prob_sums(*pred.video_logits_yuv(*planes, mask))
    return (sums / count.clamp(min=1)[:, None]).double().cpu().numpy()


def p15_throughput(torch, np, pred, dev, card: str, name: str) -> dict:
    """V=8 videos/s of forward_batched_yuv by phase 6's protocol (4
    rotating device buffers, 6 launches a trial, one sync a trial, best of
    3), then forward_batched's on RGB frames the same way."""
    g = torch.Generator(device=dev).manual_seed(5)
    bufs = []
    for i in range(4):
        yp = torch.randint(0, 256, (P15_V, FRAMES, IMG, IMG), dtype=torch.uint8, device=dev,
                           generator=g)
        cp = [torch.randint(0, 256, (P15_V, FRAMES, IMG // 2, IMG // 2), dtype=torch.uint8,
                            device=dev, generator=g) for _ in range(2)]
        bufs.append((yp, *cp))
    mat = torch.from_numpy(p15_planes(np, np.random.default_rng(0), P15_V, 1, 2)[3]).to(dev)
    mask = torch.ones(P15_V, FRAMES, device=dev)
    for i in range(2):
        pred.forward_batched_yuv(*bufs[i], mat, mask)
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(6):
            pred.forward_batched_yuv(*bufs[i % 4], mat, mask)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append((P15_V * 6 / dt, dt / 6 * 1e3))
        log(f"throughput [p15 {name}, yuv420] V=8: {rates[-1][0]:.2f} videos/s, "
            f"{rates[-1][1]:.2f} ms/launch [{card}]")
    del bufs
    best = max(rates)
    rgb = phase_throughput(torch, pred, dev, card, f"p15 {name}, rgb", v1=False)
    log(f"p15 [{name}]: V=8 yuv420 {best[0]:.2f} videos/s ({best[1]:.2f} ms/launch) against "
        f"rgb {rgb['v8_videos_s']:.2f} ({rgb['v8_ms']:.2f}) in this call: "
        f"{best[0] / rgb['v8_videos_s']:.3f}x [{card}]")
    return {"yuv_videos_s": best[0], "yuv_ms": best[1], "rgb_videos_s": rgb["v8_videos_s"],
            "rgb_ms": rgb["v8_ms"]}


def p15_forward(torch, np, dev, card: str, params: dict) -> tuple:
    """15b: forward_batched_yuv at V=8 in the default plan and under
    int8_heads + 'full' against the float32 plain path on the same planes;
    launches a forward; videos/s beside forward_batched's. Returns (the
    records, the default plan's fullframe Predictor)."""
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops import cuda as kcuda
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

    rng = np.random.default_rng(151)
    planes = tuple(torch.from_numpy(a).to(dev) for a in p15_planes(np, rng, P15_V))
    mask = torch.ones(P15_V, FRAMES, device=dev)
    mask[1, 8:] = 0
    mask[3, 2:] = 0
    base = Predictor(p14_config(), device=dev, params=params, dtype=torch.float32,
                     deterministic_vae=True, kernel_plan=KernelPlan(), face_backend="fullframe")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m32 = p15_yuv_means(torch, np, base, planes, mask)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del base
    torch.cuda.empty_cache()
    log(f"p15 [yuv forward]: f32 plain class means {np.round(m32, 5).tolist()}")
    out, keep = {}, None
    for name, plan in (("default", KernelPlan()),
                       ("int8_heads+full", KernelPlan(int8_heads=True, int8_mlp="full"))):
        pred = Predictor(p14_config(), device=dev, params=params, deterministic_vae=True,
                         kernel_plan=plan, face_backend="fullframe")
        kcuda.reset_launch_counts()
        m16 = p15_yuv_means(torch, np, pred, planes, mask)
        got = kcuda.launch_counts()
        want = expected_launches(kcuda, "", plan.int8_mlp, plan.int8_heads)
        if got != want:
            raise AssertionError(f"p15 [{name}] forward_batched_yuv: launches {got}, want {want}")
        rec = {"launches": {k: v for k, v in got.items() if v}}
        rec["dy_val"] = verdict_parity(np, card, f"p15 {name}", m16, m32, "yuv420 vs f32 plain",
                                       YVAL_TOL_INT8 if plan.int8_mlp else YVAL_TOL)
        rec.update(p15_throughput(torch, np, pred, dev, card, name))
        out[name] = rec
        if name == "default":
            keep = pred
        else:
            del pred
            torch.cuda.empty_cache()
    return out, keep


def p15_stream(torch, np, pred, dev, card: str) -> dict:
    """15c: predict_videos_stream_yuv over four V=8 host batches against
    forward_batched_yuv on each, bit for bit; timed against
    predict_videos_stream on the RGB frames of the same videos."""
    from genconvit_tpu_torch.data.preprocess import yuv420_to_rgb

    rng = np.random.default_rng(152)
    batches, rgb_batches = [], []
    for _ in range(STREAM_BATCHES):
        y, u, w, m = p15_planes(np, rng, P15_V)
        mask = np.ones((P15_V, FRAMES), np.float32)
        mask[2, 5:] = 0
        batches.append(((y, u, w), m, mask))
        n = P15_V * FRAMES
        rgb = yuv420_to_rgb(*(torch.from_numpy(a.reshape((n,) + a.shape[2:])).to(dev)
                              for a in (y, u, w)),
                            torch.from_numpy(np.repeat(m, FRAMES, axis=0)).to(dev))
        rgb_batches.append((rgb.round().to(torch.uint8).reshape(
            P15_V, FRAMES, IMG, IMG, 3).cpu().numpy(), mask))
    got = pred.predict_videos_stream_yuv(batches)
    for b, ((planes, m, mask), (gy, gv)) in enumerate(zip(batches, got, strict=True)):
        wy, wv = pred.forward_batched_yuv(*(torch.from_numpy(a).to(dev) for a in planes),
                                          torch.from_numpy(m).to(dev),
                                          torch.from_numpy(mask).to(dev))
        if not (np.array_equal(gy, wy.cpu().numpy()) and np.array_equal(gv, wv.cpu().numpy())):
            raise AssertionError(f"p15 stream batch {b}: {gy} {gv} != forward_batched_yuv's "
                                 f"{wy.cpu().numpy()} {wv.cpu().numpy()}")
    times = {"yuv420": [], "rgb": []}
    for _ in range(3):
        for fmt, run in (("yuv420", lambda: pred.predict_videos_stream_yuv(batches)),
                         ("rgb", lambda: pred.predict_videos_stream(rgb_batches))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            times[fmt].append((time.perf_counter() - t0) * 1e3)
    upload = {"yuv420": sum(sum(a.nbytes for a in p) for p, _, _ in batches) / STREAM_BATCHES,
              "rgb": sum(f.nbytes for f, _ in rgb_batches) / STREAM_BATCHES}
    log(f"p15 [stream]: {STREAM_BATCHES} V=8 batches, predict_videos_stream_yuv equals "
        f"forward_batched_yuv on each, bit for bit; ms (3 runs) yuv420 "
        f"{[round(t, 2) for t in times['yuv420']]} ({upload['yuv420'] / 1e6:.1f} MB a batch) "
        f"against rgb {[round(t, 2) for t in times['rgb']]} ({upload['rgb'] / 1e6:.1f} MB) "
        f"[{card}]")
    return {"yuv420_ms": min(times["yuv420"]), "rgb_ms": min(times["rgb"]),
            "mb": {k: v / 1e6 for k, v in upload.items()}}


class P15Source:
    """An in-memory stand-in for the native decoder's Python face
    (`native_available`, `NativeVideoReader`, `decode_videos_batch`): each
    video's planes at the model size, its colour transform and its RGB
    frames (the planes converted on the card and rounded), by file name. A
    name it does not hold cannot be opened (IOError; count 0 in a batch)."""

    def __init__(self, torch, np, dev):
        from genconvit_tpu_torch.data.preprocess import yuv420_to_rgb

        self.np = np
        rng = np.random.default_rng(153)
        self.videos = {}
        for i in range(P15_VIDEOS):
            name = f"p15_{i:02d}.mp4"
            if name == P15_UNREADABLE:
                continue
            n = 0 if name == P15_EMPTY else int(rng.integers(9, 31))
            y, u, w, m = p15_planes(np, rng, 1, n)
            color = P15_COLORS[i % len(P15_COLORS)]
            rgb = (yuv420_to_rgb(*(torch.from_numpy(a[0]).to(dev) for a in (y, u, w)),
                                 torch.from_numpy(m[0]).to(dev)).round().to(torch.uint8)
                   .cpu().numpy()) if n else np.zeros((0, IMG, IMG, 3), np.uint8)
            self.videos[name] = (rgb, (y[0], u[0], w[0]), color)
        self.names = [f"p15_{i:02d}.mp4" for i in range(P15_VIDEOS)]

    def _video(self, path: str):
        import os

        name = os.path.basename(path)
        if name not in self.videos:
            raise IOError(f"cannot open video: {path}")
        return self.videos[name]

    def reader(self, path: str, out_size=None):
        rgb, planes, color = self._video(path)
        if out_size is not None and tuple(out_size) != (IMG, IMG):
            raise AssertionError(f"scaled open at {out_size}, not the model size")
        return P15Reader(rgb, planes, color)

    def decode_batch(self, paths, frames_per_video: int, out_w: int, out_h: int,
                     threads: int = 0):
        from genconvit_tpu_torch.data.frames import sample_frame_indices

        np = self.np
        out = np.zeros((len(paths), frames_per_video, out_h, out_w, 3), np.uint8)
        counts = np.zeros((len(paths),), np.int64)
        for i, p in enumerate(paths):
            try:
                rgb = self._video(p)[0]
            except IOError:
                continue
            got = rgb[sample_frame_indices(len(rgb), frames_per_video)]
            out[i, : len(got)] = got
            counts[i] = len(got)
        return out, counts


class P15Reader:
    def __init__(self, rgb, planes, color):
        self._rgb, self._planes, self._color = rgb, planes, color
        self.num_frames = len(rgb)

    def __len__(self) -> int:
        return self.num_frames

    def read_frames(self, indices):
        return self._rgb[list(indices)]

    def read_frames_yuv(self, indices):
        return tuple(p[list(indices)] for p in self._planes)

    def color_info(self):
        return self._color

    def close(self) -> None:
        pass


def p15_references(torch, np, pred, src: P15Source) -> dict:
    """Each readable video's verdict by forward_batched_yuv on its own
    planes and transform and by forward_batched on its RGB frames, both at
    V=8 (the drivers' frame selection and mask)."""
    from genconvit_tpu_torch.data.frames import sample_frame_indices
    from genconvit_tpu_torch.data.preprocess import yuv_affine

    names = [n for n in src.names if n in src.videos and len(src.videos[n][0])]
    ref = {"yuv420": {}, "rgb": {}}
    for g in range(0, len(names), P15_V):
        group = names[g: g + P15_V]
        y = np.zeros((P15_V, FRAMES, IMG, IMG), np.uint8)
        u = np.zeros((P15_V, FRAMES, IMG // 2, IMG // 2), np.uint8)
        w = np.zeros_like(u)
        rgb = np.zeros((P15_V, FRAMES, IMG, IMG, 3), np.uint8)
        m = np.zeros((P15_V, 3, 4), np.float32)
        mask = np.zeros((P15_V, FRAMES), np.float32)
        for i, n in enumerate(group):
            frames, planes, color = src.videos[n]
            idx = sample_frame_indices(len(frames), FRAMES)
            k = len(idx)
            y[i, :k], u[i, :k], w[i, :k] = (p[idx] for p in planes)
            rgb[i, :k] = frames[idx]
            m[i] = yuv_affine(*color)
            mask[i, :k] = 1
        dev = pred.device
        outs = {"yuv420": pred.forward_batched_yuv(*(torch.from_numpy(a).to(dev)
                                                     for a in (y, u, w, m, mask))),
                "rgb": pred.forward_batched(torch.from_numpy(rgb).to(dev),
                                            torch.from_numpy(mask).to(dev))}
        for fmt, (vy, vv) in outs.items():
            vy, vv = vy.cpu().numpy(), vv.cpu().numpy()
            for i, n in enumerate(group):
                ref[fmt][n] = (int(vy[i]), float(vv[i]))
    return ref


def p15_check_driver(fmt: str, res: dict, ref: dict) -> float:
    """A driver's verdicts against the references; the unreadable video
    None (yuv420) or the default (rgb: its count is 0), the empty one the
    default. Returns max|d y_val|."""
    want_bad = None if fmt == "yuv420" else (0, 0.5)
    if res[P15_UNREADABLE] != want_bad or res[P15_EMPTY] != (0, 0.5):
        raise AssertionError(f"p15 [{fmt}]: unreadable {res[P15_UNREADABLE]} (want {want_bad}), "
                             f"empty {res[P15_EMPTY]} (want (0, 0.5))")
    worst = 0.0
    for n, want in ref.items():
        got = res[n]
        d = abs(got[1] - want[1])
        worst = max(worst, d)
        if not d <= P15_DRIVER_TOL or (abs(want[1] - 0.5) > P15_DRIVER_TOL and got[0] != want[0]):
            raise AssertionError(f"p15 [{fmt}] {n}: {got} against forward's {want}")
    return worst


def p15_drivers(torch, np, pred, card: str, tmp: str, params: dict) -> dict:
    """15d and 15e: predict_files under 'rgb' (predict_files_native_rgb)
    and 'yuv420' (predict_files_yuv), extract_faces/predict_video on one
    path and the prediction CLI, with the decoder's Python face swapped for
    an in-memory source (and put back after)."""
    import functools
    import os

    from genconvit_tpu_torch import prediction
    from genconvit_tpu_torch.data import native
    from genconvit_tpu_torch.infer.aggregate import real_or_fake
    from genconvit_tpu_torch.ops import cuda as kcuda

    src = P15Source(torch, np, pred.device)
    paths = [os.path.join(tmp, n) for n in src.names]
    ref = p15_references(torch, np, pred, src)
    saved = {k: getattr(native, k) for k in ("native_available", "NativeVideoReader",
                                             "decode_videos_batch")}
    native.native_available = lambda: True
    native.NativeVideoReader = src.reader
    native.decode_videos_batch = src.decode_batch
    out = {}
    try:
        for fmt, groups in (("rgb", [src.names[g: g + VIDEO_BATCH]
                                     for g in range(0, P15_VIDEOS, VIDEO_BATCH)]),
                            ("yuv420", [src.names])):
            pred.transfer_format = fmt
            launches = sum(any(n in ref["rgb"] for n in grp) for grp in groups)
            want = {k: v * launches for k, v in
                    expected_launches(kcuda, "", "", False).items()}
            rates = []
            for run in range(3):
                kcuda.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = dict(pred.predict_files(paths, FRAMES))
                rates.append(P15_VIDEOS / (time.perf_counter() - t0))
                got = kcuda.launch_counts()
                if got != want:
                    raise AssertionError(f"p15 [{fmt}] predict_files: launches {got}, want "
                                         f"{want} ({launches} group forwards)")
                res = {os.path.basename(p): v for p, v in res.items()}
                worst = p15_check_driver(fmt, res, ref[fmt])
            rates.sort()
            out[fmt] = {"worst": worst, "videos_s": rates[1], "spread": (rates[0], rates[2]),
                        "launches": launches, "res": res}
            log(f"p15 [predict_files {fmt}]: {launches} group forward(s), {54 * launches} K1 + "
                f"{3 * launches} K2 in all; every verdict within {worst:.3e} of "
                f"forward_batched{'_yuv' if fmt == 'yuv420' else ''} on the same "
                f"{'planes' if fmt == 'yuv420' else 'frames'} (limit {P15_DRIVER_TOL}); "
                f"unreadable -> {res[P15_UNREADABLE]}, no frames -> {res[P15_EMPTY]}; "
                f"median {rates[1]:.2f} videos/s (min {rates[0]:.2f}, max {rates[2]:.2f}) over "
                f"3 runs of {P15_VIDEOS} [{card}]")
        # one path: extract_faces decodes straight to the model size
        from genconvit_tpu_torch.data.frames import sample_frame_indices

        pred.transfer_format = "rgb"
        one = paths[0]
        faces = pred.extract_faces(one, FRAMES)
        frames = src.videos[src.names[0]][0]
        if not np.array_equal(faces.cpu().numpy(),
                              frames[sample_frame_indices(len(frames), FRAMES)]):
            raise AssertionError("p15 extract_faces: not the source's frames")
        kcuda.reset_launch_counts()
        single = pred.predict_video(one, FRAMES)
        if kcuda.launch_counts() != expected_launches(kcuda, "", "", False):
            raise AssertionError(f"p15 predict_video: launches {kcuda.launch_counts()}")
        d1 = abs(single[1] - ref["rgb"][src.names[0]][1])
        if not d1 <= P15_DRIVER_TOL:
            raise AssertionError(f"p15 predict_video {single} vs {ref['rgb'][src.names[0]]}")
        log(f"p15 [one path]: extract_faces gave the source's frames at {IMG} px, bit for bit; "
            f"predict_video {single}, {d1:.3e} from forward_batched; 54 K1 + 3 K2 [{card}]")
        # e. the CLI in-process over placeholder files
        vdir = os.path.join(tmp, "p15_videos")
        os.makedirs(vdir)
        for n in src.names:
            open(os.path.join(vdir, n), "wb").close()
        build = prediction.Predictor
        prediction.Predictor = functools.partial(build, params=params)
        try:
            t0 = time.perf_counter()
            kcuda.reset_launch_counts()
            path = prediction.main(["--p", vdir, "--f", str(FRAMES), "--face-backend",
                                    "fullframe", "--transfer-format", "yuv420",
                                    "--deterministic-vae",
                                    "--result-dir", os.path.join(tmp, "p15_result")])
            dt = time.perf_counter() - t0
            cli_launches = kcuda.launch_counts()
        finally:
            prediction.Predictor = build
        with open(path) as f:
            result = json.load(f)
        keys = {"name", "pred", "klass", "pred_label", "correct_label"}
        meta = {"dataset", "network", "num_frames", "runtime_seconds", "timestamp", "framework"}
        if set(result) != {"video", "metadata"} or set(result["video"]) != keys \
                or set(result["metadata"]) != meta or result["video"]["name"] != src.names:
            raise AssertionError(f"p15 CLI result: keys {sorted(result)}, video "
                                 f"{sorted(result['video'])}, names {result['video']['name']}")
        if cli_launches != expected_launches(kcuda, "", "", False):
            raise AssertionError(f"p15 CLI: launches {cli_launches}, want one group forward")
        worst = 0.0
        for n, pv, label in zip(result["video"]["name"], result["video"]["pred"],
                                result["video"]["pred_label"]):
            want = out["yuv420"]["res"][n] or (0, 0.5)
            worst = max(worst, abs(pv - want[1]))
            if not abs(pv - want[1]) <= P15_DRIVER_TOL or (
                    abs(want[1] - 0.5) > P15_DRIVER_TOL and label != real_or_fake(want[0])):
                raise AssertionError(f"p15 CLI {n}: {label} {pv} against 15d's {want}")
        log(f"p15 [CLI]: prediction.main --face-backend fullframe --transfer-format yuv420 over "
            f"{P15_VIDEOS} placeholder files {dt:.2f} s (Predictor built from the phase's "
            f"weights), the JAX package's result keys, one group forward, verdicts within "
            f"{worst:.3e} of 15d's [{card}]")
    finally:
        for k, v in saved.items():
            setattr(native, k, v)
        pred.transfer_format = "rgb"
    return out


def phase_p15(torch, np, dev, card: str, tmp: str) -> dict:
    """Phase 15 (module docstring): the fullframe fast paths' device half."""
    import gc

    out = {"conversion": p15_conversion(torch, np, dev, card)}
    params = p14_params(torch, dev, seed=15)
    out["forward"], pred = p15_forward(torch, np, dev, card, params)
    out["stream"] = p15_stream(torch, np, pred, dev, card)
    out["drivers"] = p15_drivers(torch, np, pred, card, tmp, params)
    del pred, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p15_summary(p15: dict, card: str) -> None:
    c = p15["conversion"]
    log(f"summary [p15 conversion]: card vs CPU {c['err']:.3e}; normalize_yuv420 "
        f"{c['ms_yuv']:.4f} ms against normalize_batch {c['ms_rgb']:.4f} ms [{card}]")
    for name, r in p15["forward"].items():
        log(f"summary [p15 {name}]: yuv420 V=8 {r['yuv_videos_s']:.2f} videos/s "
            f"({r['yuv_ms']:.2f} ms/launch), rgb {r['rgb_videos_s']:.2f} ({r['rgb_ms']:.2f}); "
            f"launches a forward {r['launches']}; max|dy_val| vs f32 plain {r['dy_val']:.3e} "
            f"[{card}]")
    s = p15["stream"]
    log(f"summary [p15 stream]: {STREAM_BATCHES} V=8 batches yuv420 {s['yuv420_ms']:.2f} ms "
        f"({s['mb']['yuv420']:.1f} MB a batch) against rgb {s['rgb_ms']:.2f} ms "
        f"({s['mb']['rgb']:.1f} MB), best of 3 [{card}]")
    for fmt in ("rgb", "yuv420"):
        r = p15["drivers"][fmt]
        log(f"summary [p15 predict_files {fmt}]: median {r['videos_s']:.2f} videos/s (min "
            f"{r['spread'][0]:.2f}, max {r['spread'][1]:.2f}) over {P15_VIDEOS} in-memory videos, "
            f"{r['launches']} group forward(s); max|d y_val| {r['worst']:.3e} [{card}]")


P16_V = 8             # 16a/16b: predict_sharded's videos (4 a rank in 16b)
P16_F_LONG = 60       # predict_long_video's frames (30 a rank in 16b) ...
P16_TAIL = 7          # ... the last of them masked
P16_RANKS = 2         # 16b: spawned ranks sharing the card, gloo on CUDA tensors
P16_LONG_TOL = 1e-6   # 16a: predict_long_video vs forward_batched on [1, F]
P16_TOL = 5e-4        # 16b: a rank's verdicts vs 16a's one-process forward on the same
                      # block of videos or frames (the same bf16 path and batch)
P16_BATCH = 16        # 16b: the global training batch (8 a rank)
P16_LOSS_TOL = 1e-4   # 16b: float32 step vs the one-process step: loss, relative
P16_CHANGE_TOL = 1e-3  # ... and the parameter change, relative L2
P16_BF16_TOL = 1e-2   # 16b: bf16 step's loss vs the one-process bf16 step (tests/test_torch_train.py)
P16_TIMEOUT = 600.0   # 16b: every rank killed past this


def p16_inputs(torch, dev) -> dict:
    """Phase 16's seeded inputs on the card: V=8 videos of 15 frames with
    two masked tails, one video of 60 frames whose last 7 are masked."""
    g = torch.Generator(device=dev).manual_seed(16)
    frames = torch.randint(0, 256, (P16_V, FRAMES, IMG, IMG, 3), dtype=torch.uint8, device=dev,
                           generator=g)
    mask = torch.ones(P16_V, FRAMES, device=dev)
    mask[1, 8:] = 0
    mask[3, 2:] = 0
    long = torch.randint(0, 256, (P16_F_LONG, IMG, IMG, 3), dtype=torch.uint8, device=dev,
                         generator=g)
    lmask = torch.ones(P16_F_LONG, device=dev)
    lmask[-P16_TAIL:] = 0
    return {"frames": frames, "mask": mask, "long": long, "lmask": lmask}


def p16_blocks(torch, pred, d: dict) -> dict:
    """16b's one-process references: forward_batched on each rank's block of
    the V videos, and the long video's masked frame sums over each rank's
    block of frames, added, then aggregated (what P16_RANKS ranks compute,
    in one process): {'y', 'v', 'yl', 'vl'}."""
    from genconvit_tpu_torch.infer.aggregate import finish_aggregate, masked_prob_sums

    b = P16_V // P16_RANKS
    ys, vs = zip(*(pred.forward_batched(d["frames"][i:i + b], d["mask"][i:i + b])
                   for i in range(0, P16_V, b)))
    f = P16_F_LONG // P16_RANKS
    total = 0
    for i in range(0, P16_F_LONG, f):
        logits, mask = pred.video_logits(d["long"][None, i:i + f], d["lmask"][None, i:i + f])
        sums, count = masked_prob_sums(logits[0], mask[0])
        total = total + torch.cat([sums, count[None]])
    yl, vl = finish_aggregate(total[:2], total[2])
    return {"y": torch.cat(ys).cpu().numpy(), "v": torch.cat(vs).cpu().numpy(),
            "yl": int(yl), "vl": float(vl)}


def p16_model(torch, dev):
    """16b's float32 master model (convnext_tiny GenConViT at full width,
    layer scale U(0.1, 1), seeded as TrainBench makes it), its weights w0,
    a seeded uint8 batch of P16_BATCH, labels and eps: the same on every
    rank and in every run."""
    from genconvit_tpu_torch.models.convnext import Block
    from genconvit_tpu_torch.train import loop

    model = loop.new_model(p14_config(), "genconvit", dev, seed=16)
    g = torch.Generator(device=dev).manual_seed(16)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Block):
                m.gamma.uniform_(0.1, 1.0, generator=g)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    x = torch.randint(0, 256, (P16_BATCH, IMG, IMG, 3), dtype=torch.uint8, device=dev,
                      generator=g)
    y = torch.randint(0, 2, (P16_BATCH,), device=dev, generator=g)
    eps = torch.randn((P16_BATCH, model.vae.encoder.mu.out_features), device=dev, generator=g)
    return model, w0, (x, y, eps)


def p16_step(torch, model, w0, batch, dtype, group):
    """One train step from w0 (a fresh optimizer) under the default plan:
    (loss, the parameters after it, launches)."""
    from genconvit_tpu_torch.ops import cuda as kcuda
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
    from genconvit_tpu_torch.parallel.mesh import shard_rows
    from genconvit_tpu_torch.train import loop, optim

    model.load_state_dict(w0)
    model.zero_grad(set_to_none=True)
    opt = optim.make_optimizer(model.parameters(), 1e-4, 1e-4)
    step = loop.make_train_step(model, "genconvit", opt, False, dtype, KernelPlan(), group)
    x, y, eps = batch
    if group is not None:   # the step takes this rank's rows of the images
        x = x[shard_rows(len(y), group)]
    kcuda.reset_launch_counts()
    loss = float(step(x, y, eps.to(dtype))[0])
    counts = kcuda.launch_counts()
    return loss, {n: p.detach().clone() for n, p in model.named_parameters()}, counts


def p16_change_error(torch, w0, got: dict, ref: dict) -> float:
    """Relative L2 of the parameter change got - w0 against ref - w0, over
    every parameter."""
    num = den = 0.0
    for n, r in ref.items():
        d_ref = (r - w0[n]).double()
        num += float((got[n] - w0[n]).double().sub_(d_ref).square().sum())
        den += float(d_ref.square().sum())
    return (num / max(den, 1e-300)) ** 0.5


def p16_rank(rank: int, n: int, weights: str, inputs: str) -> dict:
    """16b, one of the ranks sharing the card (gloo on CUDA tensors): the
    sharded eval on the weights of 16a, then the data-parallel steps; rank 0
    also runs the one-process steps and compares. Returns its readings."""
    import torch
    import torch.distributed as dist

    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.models import vae as vae_mod
    from genconvit_tpu_torch.ops import cuda as kcuda
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
    from genconvit_tpu_torch.parallel import eval_shard
    from genconvit_tpu_torch.parallel.mesh import data_group, make_mesh
    from genconvit_tpu_torch.parallel.multihost import rank_device

    dev = rank_device()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh()
    group = data_group(mesh)
    out = {}
    pred = Predictor(p14_config(), net="genconvit", device=dev,
                     params=torch.load(weights, map_location=dev), deterministic_vae=True,
                     kernel_plan=KernelPlan())
    d = {k: v.to(dev) for k, v in torch.load(inputs).items()}
    eval_shard.predict_sharded(pred, d["frames"], d["mask"], mesh)    # the broadcast, warm-up
    torch.cuda.synchronize()
    kcuda.reset_launch_counts()
    t0 = time.perf_counter()
    out["sharded"] = eval_shard.predict_sharded(pred, d["frames"], d["mask"], mesh)
    out["sharded_s"] = time.perf_counter() - t0
    out["sharded_counts"] = kcuda.launch_counts()
    kcuda.reset_launch_counts()
    out["long"] = eval_shard.predict_long_video(pred, d["long"], d["lmask"], mesh)
    out["long_counts"] = kcuda.launch_counts()
    real_gather = eval_shard.gather_blocks
    eval_shard.gather_blocks = lambda rows, index, k, grp: real_gather(rows, (index + 1) % k,
                                                                        k, grp)
    try:
        out["rotated"] = eval_shard.predict_sharded(pred, d["frames"], d["mask"], mesh)
    finally:
        eval_shard.gather_blocks = real_gather
    del pred, d
    torch.cuda.empty_cache()

    model, w0, batch = p16_model(torch, dev)
    t0 = time.perf_counter()
    loss, params, _ = p16_step(torch, model, w0, batch, torch.float32, group)
    out["f32"] = {"loss": loss, "s": time.perf_counter() - t0}
    ref = None
    if rank == 0:
        ref = p16_step(torch, model, w0, batch, torch.float32, None)[:2]
        out["f32"].update(ref_loss=ref[0], change=p16_change_error(torch, w0, params, ref[1]))
    del params
    dist.barrier(group=group)
    t0 = time.perf_counter()
    loss, params, counts = p16_step(torch, model, w0, batch, torch.bfloat16, group)
    out["bf16"] = {"loss": loss, "counts": counts, "s": time.perf_counter() - t0}
    del params
    if rank == 0:
        out["bf16"]["ref_loss"] = p16_step(torch, model, w0, batch, torch.bfloat16, None)[0]
    dist.barrier(group=group)
    # each rank's own BatchNorm statistics: the planted fault
    real_bn = vae_mod.batch_norm_train
    vae_mod.batch_norm_train = lambda x, bn, momentum=0.1, eps=1e-5, group=None: real_bn(
        x, bn, momentum, eps)
    try:
        loss, params, _ = p16_step(torch, model, w0, batch, torch.float32, group)
    finally:
        vae_mod.batch_norm_train = real_bn
    out["planted_bn"] = {"loss": loss}
    if rank == 0:
        out["planted_bn"]["change"] = p16_change_error(torch, w0, params, ref[1])
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def p16_rates(torch, pred, d: dict, mesh, card: str) -> dict:
    """V=8 videos/s of predict_sharded beside forward_batched by phase 6's
    protocol (2 warm-up calls, 3 trials of 6 calls, best), in turns, on the
    same device-resident batch: predict_sharded fetches its verdicts every
    call, forward_batched once a trial."""
    from genconvit_tpu_torch.parallel.eval_shard import predict_sharded

    calls = {"forward_batched": lambda: pred.forward_batched(d["frames"], d["mask"]),
             "predict_sharded": lambda: predict_sharded(pred, d["frames"], d["mask"], mesh)}
    for fn in calls.values():
        fn()
        fn()
    rates = {k: [] for k in calls}
    for _ in range(3):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(6):
                fn()
            torch.cuda.synchronize()
            rates[name].append(P16_V * 6 / (time.perf_counter() - t0))
    for name, r in rates.items():
        log(f"p16a throughput [{name}] V=8: {', '.join(f'{x:.2f}' for x in r)} videos/s "
            f"[{card}]")
    return {k: max(r) for k, r in rates.items()}


def phase_p16(torch, np, dev, card: str, tmp: str) -> dict:
    """Phase 16 (module docstring): data parallelism on torch.distributed."""
    import gc
    import os

    import torch.distributed as dist

    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops import cuda as kcuda
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
    from genconvit_tpu_torch.parallel.dryrun import Ranks
    from genconvit_tpu_torch.parallel.eval_shard import predict_long_video, predict_sharded
    from genconvit_tpu_torch.parallel.mesh import make_mesh
    from genconvit_tpu_torch.parallel.multihost import initialize_multihost

    t = time.perf_counter()
    want = expected_launches(kcuda, "", "", False)
    pred = Predictor(p14_config(), net="genconvit", device=dev,
                     params=p14_params(torch, dev, seed=16), deterministic_vae=True,
                     kernel_plan=KernelPlan())
    d = p16_inputs(torch, dev)
    y_ref, v_ref = (a.cpu().numpy() for a in pred.forward_batched(d["frames"], d["mask"]))
    yl_ref, vl_ref = (a.cpu().numpy()[0] for a in
                      pred.forward_batched(d["long"][None], d["lmask"][None]))
    blk = p16_blocks(torch, pred, d)
    dv_batch = float(np.abs(blk["v"] - v_ref).max())
    dl_batch = abs(blk["vl"] - float(vl_ref))
    log(f"p16a: one process, the V={P16_V} forward against {P16_RANKS} blocks of "
        f"{P16_V // P16_RANKS} videos: max|dy_val| {dv_batch:.3e}, y equal "
        f"{bool(np.array_equal(blk['y'], y_ref))}; the F={P16_F_LONG} video against its "
        f"{P16_RANKS} halves' summed frames: |dy_val| {dl_batch:.3e} (the batch effect alone, "
        f"bf16) [{card}]")
    out = {}
    # 16a: NCCL, world 1, in this process
    initialize_multihost(f"file://{os.path.join(tmp, 'p16a_store')}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh()
        predict_sharded(pred, d["frames"], d["mask"], mesh)   # the broadcast and refold, once
        kcuda.reset_launch_counts()
        y, v = predict_sharded(pred, d["frames"], d["mask"], mesh)
        got = kcuda.launch_counts()
        if got != want:
            raise AssertionError(f"p16a predict_sharded: launches {got}, want {want}")
        if not (np.array_equal(y, y_ref) and np.array_equal(v, v_ref)):
            raise AssertionError(f"p16a predict_sharded not bit-equal to forward_batched: "
                                 f"{y} {v} against {y_ref} {v_ref}")
        kcuda.reset_launch_counts()
        yl, vl = predict_long_video(pred, d["long"], d["lmask"], mesh)
        got = kcuda.launch_counts()
        if got != want:
            raise AssertionError(f"p16a predict_long_video: launches {got}, want {want}")
        dl = abs(vl - float(vl_ref))
        if not (yl == int(yl_ref) and dl <= P16_LONG_TOL):
            raise AssertionError(f"p16a predict_long_video ({yl}, {vl}) against forward_batched "
                                 f"({int(yl_ref)}, {float(vl_ref)}): |dy_val| {dl}")
        log(f"p16a [nccl, world 1]: predict_sharded V={P16_V} bit-equal to forward_batched "
            f"(y {y.tolist()}); predict_long_video F={P16_F_LONG} ({P16_TAIL} masked) y {yl}, "
            f"|dy_val| {dl:.3e} (limit {P16_LONG_TOL}); {want['ln_mlp_residual']} K1 + "
            f"{want['layer_norm_rows']} K2 a forward [{card}]")
        out["rates"] = p16_rates(torch, pred, d, mesh, card)
        out["long_err"] = dl
    finally:
        dist.destroy_process_group()
    weights = os.path.join(tmp, "p16_weights.pt")
    inputs = os.path.join(tmp, "p16_inputs.pt")
    torch.save({b: getattr(pred.model, b).state_dict() for b in ("ed", "vae")}, weights)
    torch.save({k: v.cpu() for k, v in d.items()}, inputs)
    del pred, d
    gc.collect()
    torch.cuda.empty_cache()
    log(f"p16a: {time.perf_counter() - t:.1f} s")

    # 16b: two spawned ranks on this card, gloo on CUDA tensors
    t = time.perf_counter()
    ranks = Ranks(p16_rank, P16_RANKS, weights, inputs).join(timeout=P16_TIMEOUT)
    os.remove(weights)
    out["ranks_s"] = time.perf_counter() - t
    train_want = {k: 2 * v for k, v in want.items()}   # forward and recompute
    for rank, r in enumerate(ranks):
        for what in ("sharded_counts", "long_counts"):
            if r[what] != want:
                raise AssertionError(f"p16b rank {rank} {what}: {r[what]}, want {want}")
        if r["bf16"]["counts"] != train_want:
            raise AssertionError(f"p16b rank {rank} bf16 step: launches {r['bf16']['counts']}, "
                                 f"want {train_want}")
        y, v = r["sharded"]
        if not np.array_equal(y, blk["y"]):
            raise AssertionError(f"p16b rank {rank}: y {y} against 16a's {blk['y']}")
        r["dv"] = float(np.abs(v - blk["v"]).max())
        r["dl"] = abs(r["long"][1] - blk["vl"])
        if not (r["dv"] <= P16_TOL and r["long"][0] == blk["yl"] and r["dl"] <= P16_TOL):
            raise AssertionError(f"p16b rank {rank}: max|dy_val| {r['dv']}, long video "
                                 f"{r['long']} against ({blk['yl']}, {blk['vl']})")
        r["dv8"] = float(np.abs(v - v_ref).max())
        r["dl60"] = abs(r["long"][1] - float(vl_ref))
        if not (r["dv8"] <= YVAL_TOL and r["dl60"] <= YVAL_TOL):
            raise AssertionError(f"p16b rank {rank}: against the V={P16_V} and F={P16_F_LONG} "
                                 f"forwards max|dy_val| {r['dv8']}, {r['dl60']} > {YVAL_TOL}")
        yr, vr = r["rotated"]
        if np.array_equal(yr, blk["y"]) and float(np.abs(vr - blk["v"]).max()) <= P16_TOL:
            raise AssertionError(f"p16b rank {rank}: the rotated gather passed the check")
    f32, bf16, planted = ranks[0]["f32"], ranks[0]["bf16"], ranks[0]["planted_bn"]
    dloss = abs(f32["loss"] - f32["ref_loss"]) / abs(f32["ref_loss"])
    dloss16 = abs(bf16["loss"] - bf16["ref_loss"]) / abs(bf16["ref_loss"])
    dloss_pl = abs(planted["loss"] - f32["ref_loss"]) / abs(f32["ref_loss"])
    if not (dloss <= P16_LOSS_TOL and f32["change"] <= P16_CHANGE_TOL):
        raise AssertionError(f"p16b f32 step vs one process: loss rel {dloss}, parameter change "
                             f"rel L2 {f32['change']}")
    if not dloss16 <= P16_BF16_TOL:
        raise AssertionError(f"p16b bf16 step vs one process: loss rel {dloss16}")
    if dloss_pl <= P16_LOSS_TOL and planted["change"] <= P16_CHANGE_TOL:
        raise AssertionError(f"p16b per-rank BatchNorm statistics passed the check: loss rel "
                             f"{dloss_pl}, change {planted['change']}")
    for rank, r in enumerate(ranks):
        if r["f32"]["loss"] != f32["loss"] or r["bf16"]["loss"] != bf16["loss"]:
            raise AssertionError(f"p16b rank {rank}: its losses {r['f32']['loss']}, "
                                 f"{r['bf16']['loss']} differ from rank 0's")
    log(f"p16b [{P16_RANKS} ranks on one card, gloo]: predict_sharded y equal, max|dy_val| "
        f"{max(r['dv'] for r in ranks):.3e} against 16a's blocks, long video "
        f"{max(r['dl'] for r in ranks):.3e} against its halves (limit {P16_TOL}); against the "
        f"V={P16_V} and F={P16_F_LONG} forwards {max(r['dv8'] for r in ranks):.3e} and "
        f"{max(r['dl60'] for r in ranks):.3e} (limit {YVAL_TOL}); f32 step N={P16_BATCH} loss {f32['loss']:.6f} against "
        f"{f32['ref_loss']:.6f} (rel {dloss:.2e}, limit {P16_LOSS_TOL}), parameter change rel "
        f"L2 {f32['change']:.3e} (limit {P16_CHANGE_TOL}); bf16 step loss rel {dloss16:.2e} "
        f"(limit {P16_BF16_TOL}), launches a rank {train_want['ln_mlp_residual']} K1 + "
        f"{train_want['layer_norm_rows']} K2; planted per-rank BatchNorm statistics: loss rel "
        f"{dloss_pl:.2e}, change {planted['change']:.3e} (caught); the rotated gather caught "
        f"[{card}]")
    log(f"p16b time-sliced on one card (not scaling): predict_sharded V={P16_V} "
        f"{max(r['sharded_s'] for r in ranks) * 1e3:.1f} ms a call, f32 step "
        f"{max(r['f32']['s'] for r in ranks):.2f} s, bf16 step "
        f"{max(r['bf16']['s'] for r in ranks):.2f} s; peak device memory a rank "
        f"{max(r['peak_gib'] for r in ranks):.2f} GiB; {out['ranks_s']:.1f} s [{card}]")
    out.update(sharded_dv=max(r["dv"] for r in ranks), long_dv=max(r["dl"] for r in ranks),
               sharded_dv8=max(r["dv8"] for r in ranks), long_dv60=max(r["dl60"] for r in ranks),
               batch_dv=dv_batch, batch_dl=dl_batch,
               f32_dloss=dloss, f32_change=f32["change"], bf16_dloss=dloss16,
               planted_dloss=dloss_pl, planted_change=planted["change"],
               sharded_ms=max(r["sharded_s"] for r in ranks) * 1e3,
               f32_s=max(r["f32"]["s"] for r in ranks), bf16_s=max(r["bf16"]["s"] for r in ranks))
    return out


def p16_summary(p16: dict, card: str) -> None:
    r = p16["rates"]
    log(f"summary [p16a]: V=8 predict_sharded {r['predict_sharded']:.2f} videos/s against "
        f"forward_batched {r['forward_batched']:.2f} (nccl, world 1); long video |dy_val| "
        f"{p16['long_err']:.3e} [{card}]")
    log(f"summary [p16b]: {P16_RANKS} gloo ranks on one card: max|dy_val| {p16['sharded_dv']:.3e}, "
        f"long {p16['long_dv']:.3e} against 16a's blocks; against the whole-batch forwards "
        f"{p16['sharded_dv8']:.3e}, {p16['long_dv60']:.3e} (one process, blocks against the whole "
        f"batch: {p16['batch_dv']:.3e}, {p16['batch_dl']:.3e}); f32 step loss rel {p16['f32_dloss']:.2e}, change "
        f"{p16['f32_change']:.3e}; bf16 loss rel {p16['bf16_dloss']:.2e}; planted BN loss rel "
        f"{p16['planted_dloss']:.2e}, change {p16['planted_change']:.3e}; time-sliced: "
        f"predict_sharded {p16['sharded_ms']:.1f} ms, steps {p16['f32_s']:.2f} / "
        f"{p16['bf16_s']:.2f} s [{card}]")


P17_RANKS = 2         # gloo ranks sharing the card, on a 1x2 ('data', 'model') mesh
P17_TOL = 5e-3        # 17c/e: y_val vs the one-process forward of the same path: the
                      # split products round differently from the unsplit cuBLAS ones
                      # (features 1-2 bf16 ulps apart); the heads' 30x scale carries that
                      # to y_val as the bf16 batch effect does (phase 16: 1.4e-3), which
                      # 17c reads beside as its control
P17_LOSS_TOL = 1e-5   # 17d: float32 DP+TP step vs the one-process step: loss, relative
P17_GRAD_TOL = 1e-4   # ... each group of split parameters' gradients, relative L2
P17_CHANGE_TOL = 1e-3  # ... and the parameter change, relative L2
P17_K3_M = (120, 240)  # 17b: K3's rows on a rank's 6272-column shard
P17_TIMEOUT = 600.0   # every rank killed past this
# videos of the V=8 that each TP call scores past 17a (each video's verdict is
# its own, so they are held against the same videos of the one-process V=8):
# the split plain graph's float32 partial sums pass through gloo's host copies
P17_V = {"int8": 2, "stage": 4, "mlpfull": 8, "swiglu": 4, "bias": 2}   # the planted
                      # SwiGLU split runs on all eight
# the groups of split parameters, by their names in a branch
P17_GROUPS = {"mlp.fc1": lambda k: ".mlp.fc1." in k,
              "mlp.fc2": lambda k: k.endswith(".mlp.fc2.weight"),
              "head.fc": lambda k: ".head.fc." in k,
              "fc": lambda k: k.startswith("fc."),
              "fc2": lambda k: k == "fc2.weight",
              "latent heads": lambda k: k.startswith(("encoder.mu.", "encoder.var."))}


def p17_means(torch, pred, d: dict) -> dict:
    """The one-process forward of the V=8 videos under the predictor's plan:
    (y, y_val) as numpy and the class means, with each kernel's launches."""
    from genconvit_tpu_torch.infer.aggregate import finish_aggregate, masked_prob_sums
    from genconvit_tpu_torch.ops import cuda as kcuda

    kcuda.reset_launch_counts()
    with torch.inference_mode():
        logits, mask = pred.video_logits(d["frames"], d["mask"])
        sums, count = masked_prob_sums(logits, mask)
    counts = kcuda.launch_counts()
    y, v = finish_aggregate(sums, count)
    return {"y": y.cpu().numpy(), "v": v.cpu().numpy(), "counts": counts,
            "means": (sums / count.clamp(min=1.0)[:, None]).cpu().numpy()}


def p17_batch_effect(np, torch, pred, d: dict) -> float:
    """The one-process forward's own bf16 noise under the predictor's plan:
    max|dy_val| of the V=8 forward against its two blocks of 4 (the same
    function, other cuBLAS calls)."""
    whole = pred.forward_batched(d["frames"], d["mask"])[1]
    half = len(d["frames"]) // 2
    blocks = torch.cat([pred.forward_batched(d["frames"][i:i + half], d["mask"][i:i + half])[1]
                        for i in (0, half)])
    return float((whole - blocks).abs().max())


def p17_tp(torch, pred, d: dict, mesh, videos: int = P16_V) -> dict:
    """predict_sharded with tensor parallelism on the first `videos` of the
    V=8, its launches counted and timed (the split copy and its folds made
    first, `sharded_params`)."""
    from genconvit_tpu_torch.ops import cuda as kcuda
    from genconvit_tpu_torch.parallel.eval_shard import predict_sharded, sharded_params

    sharded_params(pred, mesh, tensor_parallel=True)
    torch.cuda.synchronize()
    kcuda.reset_launch_counts()
    t0 = time.perf_counter()
    y, v = predict_sharded(pred, d["frames"][:videos], d["mask"][:videos], mesh,
                           tensor_parallel=True)
    return {"y": y, "v": v, "s": time.perf_counter() - t0, "counts": kcuda.launch_counts()}


def p17_parity(np, fails: list, tag: str, got: dict, ref: dict, tol: float) -> float:
    """max|dy_val| of got (the first videos of the V=8) against ref (<=
    tol) and y equal wherever ref's class means differ by more than twice
    tol, at least one such video; a miss is appended to fails (the phase
    raises once every reading is printed)."""
    k = len(got["v"])
    dv = float(np.abs(got["v"] - ref["v"][:k]).max())
    decisive = np.abs(ref["means"][:k, 0] - ref["means"][:k, 1]) > 2 * tol
    if not (dv <= tol and decisive.any()
            and (got["y"][decisive] == ref["y"][:k][decisive]).all()):
        fails.append(f"{tag}: max|dy_val| {dv} (limit {tol}), y {got['y'].tolist()} against "
                     f"{ref['y'][:k].tolist()} on {int(decisive.sum())} decisive")
    return dv


def p17_grads(torch, model) -> tuple:
    """(every parameter's gradient, every parameter) of a model after a
    step, by branch and name, cloned."""
    from genconvit_tpu_torch.train import loop

    return ({b: {k: p.grad.detach().clone() for k, p in m.named_parameters()}
             for b, m in loop.branches(model).items()},
            {b: {k: p.detach().clone() for k, p in m.named_parameters()}
             for b, m in loop.branches(model).items()})


def p17_step(torch, mesh, planted: bool = False) -> dict:
    """One float32 step of phase 16's model and batch (TF32 off), split over
    the mesh's 'model' axis and data-parallel over 'data'; planted: with
    all_reduce_sum in place of reduce_from_model. Returns the loss, the
    gradients, the parameters before and after, this rank's blocks."""
    from genconvit_tpu_torch.ops import collective
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
    from genconvit_tpu_torch.parallel.mesh import (data_group, model_axis, shard_params,
                                                   shard_rows, split_state_dict)
    from genconvit_tpu_torch.parallel.multihost import rank_device
    from genconvit_tpu_torch.train import loop, optim

    model, w0, (x, y, eps) = p16_model(torch, rank_device())
    axis = model_axis(mesh)
    w0 = {b: split_state_dict({k[len(b) + 1:]: v for k, v in w0.items()
                               if k.startswith(b + ".")}, axis.index, axis.size)
          for b in ("ed", "vae")}
    shard_params(model, mesh, tensor_parallel=True)
    group = data_group(mesh)
    opt = optim.make_optimizer(model.parameters(), 1e-4, 1e-4)
    step = loop.make_train_step(model, "genconvit", opt, plan=KernelPlan(), group=group)
    real = collective.reduce_from_model
    if planted:
        collective.reduce_from_model = collective.all_reduce_sum
    try:
        loss = float(step(x[shard_rows(len(y), group)], y, eps)[0])
    finally:
        collective.reduce_from_model = real
    grads, params = p17_grads(torch, model)
    return {"loss": loss, "grads": grads, "params": params, "w0": w0}


def p17_reference(torch, rank: int, index: int, n: int) -> dict:
    """The one-process float32 step of phase 16's model and batch, cut to
    this rank's blocks (`split_state_dict`), its loss, gradients and
    parameters after; the ranks take their turn, one at a time."""
    import torch.distributed as dist

    from genconvit_tpu_torch.parallel.mesh import split_state_dict
    from genconvit_tpu_torch.parallel.multihost import rank_device
    from genconvit_tpu_torch.train import loop, optim

    out = None
    for turn in range(n):
        if turn == rank:
            model, _, (x, y, eps) = p16_model(torch, rank_device())
            opt = optim.make_optimizer(model.parameters(), 1e-4, 1e-4)
            loss = float(loop.make_train_step(model, "genconvit", opt)(x, y, eps)[0])
            grads, params = p17_grads(torch, model)
            out = {"loss": loss,
                   "grads": {b: split_state_dict(g, index, n) for b, g in grads.items()},
                   "params": {b: split_state_dict(p, index, n) for b, p in params.items()}}
            del model, opt, grads, params
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def p17_rel(torch, got: dict, ref: dict, keys) -> float:
    num = sum(float((got[k].double() - ref[k].double()).square().sum()) for k in keys)
    den = sum(float(ref[k].double().square().sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


def p17_rank(rank: int, n: int) -> dict:
    """Phase 17 on one of the ranks sharing the card (gloo on CUDA tensors,
    a 1x2 mesh): (a)-(c) and (e)'s eval parts against the one-process
    forwards on the rank's own predictors, (d) the DP+TP step and (e)'s
    planted reduce against the one-process step. Returns its readings."""
    import hashlib

    import numpy as np
    import torch

    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops import collective
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
    from genconvit_tpu_torch.ops.cuda import int8_matmul as k3
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
    from genconvit_tpu_torch.parallel import mesh as mesh_mod
    from genconvit_tpu_torch.parallel.mesh import make_mesh, model_axis, tp_rule
    from genconvit_tpu_torch.parallel.multihost import rank_device

    t_start = time.perf_counter()
    dev = rank_device()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=1, model=n)
    axis = model_axis(mesh)
    d = p16_inputs(torch, dev)
    fails = []
    out = {"index": axis.index, "fails": fails}

    def predictor(params, plan):
        return Predictor(p14_config(), net="genconvit", device=dev, params=params,
                         deterministic_vae=True, kernel_plan=plan)

    def with_plan(pred, plan):
        pred.kernel_plan = plan
        pred.prepare_kernels()
        return pred

    # (a) the default plan: the split backbone runs the plain graph (no K1)
    params = p14_params(torch, dev, seed=17)
    pred = predictor(params, KernelPlan())
    ref_default = p17_means(torch, pred, d)
    ref_plain = p17_means(torch, with_plan(pred, KernelPlan(pallas="0")), d)
    tp = p17_tp(torch, with_plan(pred, KernelPlan()), d, mesh)
    out["a"] = {"dv_plain": p17_parity(np, fails, "p17a vs pallas '0'", tp, ref_plain,
                                       YVAL_TOL),
                "dv_default": p17_parity(np, fails, "p17a vs the default plan", tp,
                                         ref_default, YVAL_TOL),
                "counts": tp["counts"], "s": tp["s"]}
    # (e) fc2's bias added on every rank: against pallas '0'
    real_row = collective.row_linear

    def bias_everywhere(x, weight, bias, tp_axis):
        if tp_axis is None:
            return real_row(x, weight, bias, tp_axis)
        z = x.float() @ weight.float().t() + bias.float()   # before the sum
        return collective.reduce_from_model(z, tp_axis.group).to(x.dtype)

    collective.row_linear = bias_everywhere
    try:
        planted = p17_tp(torch, pred, d, mesh, P17_V["bias"])
    finally:
        collective.row_linear = real_row
    out["e_bias"] = float(np.abs(planted["v"] - ref_plain["v"][:P17_V["bias"]]).max())
    # (c) pallas 'stage' and 'mlpfull': the kernels on whole weights
    for pallas in ("stage", "mlpfull"):
        plan = KernelPlan(pallas=pallas)
        ref = p17_means(torch, with_plan(pred, plan), d)
        tp = p17_tp(torch, pred, d, mesh, P17_V[pallas])
        if tp["counts"] != ref["counts"]:
            fails.append(f"p17c {pallas}: launches a rank {tp['counts']}, one process "
                         f"{ref['counts']}")
        out[pallas] = {"dv": p17_parity(np, fails, f"p17c {pallas}", tp, ref, P17_TOL),
                       "counts": tp["counts"], "s": tp["s"],
                       "control": p17_batch_effect(np, torch, pred, d)}
    del pred
    torch.cuda.empty_cache()

    # (b) int8 heads: K3 on this rank's 6272-column shard
    pred = predictor(params, KernelPlan(int8_heads=True))
    ref = p17_means(torch, pred, d)
    tp = p17_tp(torch, pred, d, mesh, P17_V["int8"])
    if tp["counts"]["matmul_wint8"] != ref["counts"]["matmul_wint8"]:
        fails.append(f"p17b K3 launches a rank {tp['counts']['matmul_wint8']}, one process "
                     f"{ref['counts']['matmul_wint8']}")
    split, = pred._sharded_params_cache.values()
    head = split.vae.encoder.mu
    g = torch.Generator(device=dev).manual_seed(170 + rank)
    k3_checks = []
    for m in P17_K3_M:
        x = torch.randn(m, head.wq.shape[1], device=dev, generator=g).to(torch.bfloat16)
        ref_k3 = k3.matmul_wint8_plain(x, head.wq, head.scale, head.bias)
        err, rel, ulps = compare(torch, km, f"p17b K3 M={m} N={head.wq.shape[0]}",
                                 k3.matmul_wint8(x, head.wq, head.scale, head.bias), ref_k3)
        bad = must_fail(torch, km, "K3 on the shard, bias dropped",
                        k3.matmul_wint8(x, head.wq, head.scale, torch.zeros_like(head.bias)),
                        ref_k3)
        k3_checks.append((m, tuple(head.wq.shape), err, rel, ulps, bad))
    out["b"] = {"dv": p17_parity(np, fails, "p17b int8 heads", tp, ref, YVAL_TOL),
                "k3": k3_checks, "counts": tp["counts"],
                "one_k3": ref["counts"]["matmul_wint8"], "s": tp["s"]}
    del pred, split, head
    torch.cuda.empty_cache()

    # (e) a SwiGLU fc split contiguously: against pallas '0'
    sw = p14_params(torch, dev, head_act="swiglu", seed=17)
    pred = predictor(sw, KernelPlan(pallas="0"))
    ref = p17_means(torch, pred, d)
    tp = p17_tp(torch, with_plan(pred, KernelPlan()), d, mesh, P17_V["swiglu"])
    out["swiglu"] = p17_parity(np, fails, "p17e SwiGLU heads", tp, ref, P17_TOL)
    # the split copy made again (the replication kept), with the fault
    cache = pred._sharded_params_cache
    for key in [k for k in cache if k[2]]:
        del cache[key]
    real_halves = mesh_mod._halves
    mesh_mod._halves = lambda name, shapes: 1
    try:
        planted = p17_tp(torch, pred, d, mesh)
    finally:
        mesh_mod._halves = real_halves
    out["e_swiglu"] = float(np.abs(planted["v"] - ref["v"]).max())
    del pred, params, sw
    torch.cuda.empty_cache()

    # (d) the float32 DP+TP step against the one-process step, gradients too
    ref = p17_reference(torch, rank, axis.index, n)
    t0 = time.perf_counter()
    got = p17_step(torch, mesh)
    out["d_s"] = time.perf_counter() - t0
    dloss = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    errs, change_num, change_den = {}, 0.0, 0.0
    digest = hashlib.sha256()
    for b, grads in got["grads"].items():
        for name, member in P17_GROUPS.items():
            keys = [k for k in grads if member(k)]
            if keys:
                errs[f"{b} {name}"] = p17_rel(torch, grads, ref["grads"][b], keys)
        rep = [k for k in grads if tp_rule(k, grads[k].dim()) is None]
        errs[f"{b} replicated"] = p17_rel(torch, grads, ref["grads"][b], rep)
        for k, p in got["params"][b].items():
            w0 = got["w0"][b][k].double()
            dr = ref["params"][b][k].double() - w0
            change_num += float((p.double() - w0 - dr).square().sum())
            change_den += float(dr.square().sum())
        for k in sorted(rep):
            digest.update(got["params"][b][k].cpu().numpy().tobytes())
    change = (change_num / max(change_den, 1e-300)) ** 0.5
    if not (dloss <= P17_LOSS_TOL and max(errs.values()) <= P17_GRAD_TOL
            and change <= P17_CHANGE_TOL):
        fails.append(f"p17d rank {rank}: loss rel {dloss}, gradients {errs}, parameter "
                     f"change rel L2 {change}")
    out["d"] = {"loss": got["loss"], "ref_loss": ref["loss"], "dloss": dloss, "errs": errs,
                "change": change, "digest": digest.hexdigest()}
    del got
    torch.cuda.empty_cache()
    planted = p17_step(torch, mesh, planted=True)
    out["e_reduce"] = max(p17_rel(torch, planted["grads"][b], ref["grads"][b],
                                  [k for k in planted["grads"][b] if P17_GROUPS[group](k)])
                          for b in planted["grads"] for group in ("mlp.fc1", "head.fc"))
    out["e_reduce_loss"] = planted["loss"]
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["s"] = time.perf_counter() - t_start
    return out


def p17_k3_times(torch, km, k3, dev, card: str) -> dict:
    """K3 on one rank's block of the latent head at a 'model' axis of two
    (N = 6272 of 12544 columns, K = 25088) at M = 120 and 240, timed in
    this process alone beside its plain version and F.linear on the bf16
    block, with the bound; planted faults refused."""
    import torch.nn.functional as F

    from genconvit_tpu_torch.ops.quant import quantize_wint8

    g = torch.Generator(device=dev).manual_seed(1717)
    k, n = LATENT[0], LATENT[1] // P17_RANKS
    w16 = (0.01 * torch.randn(n, k, device=dev, generator=g)).to(torch.bfloat16)
    wq, sc = quantize_wint8(w16, dim=1)
    b = 0.1 * torch.randn(n, device=dev, generator=g)
    b16 = b.to(torch.bfloat16)
    rec = {"err": 0.0, "shapes": []}
    for m in P17_K3_M:
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        ref = k3.matmul_wint8_plain(x, wq, sc, b)
        err, rel, ulps = compare(torch, km, f"K3 M={m} N={n}", k3.matmul_wint8(x, wq, sc, b),
                                 ref)
        rec["err"] = max(rec["err"], err)
        bad = must_fail(torch, km, "scale by its mean",
                        k3.matmul_wint8(x, wq, sc.mean().expand_as(sc).contiguous(), b), ref)
        t_k = cuda_ms(torch, lambda: k3.matmul_wint8(x, wq, sc, b), 20)
        t_p = cuda_ms(torch, lambda: k3.matmul_wint8_plain(x, wq, sc, b), 5)
        t_l = cuda_ms(torch, lambda: F.linear(x, w16, b16), 20)
        bd, by = bound(m * k * 2 + n * k + 8 * n + m * n * 2, {BF16: 2 * m * k * n})
        rec["shapes"].append((m, t_k, t_p, t_l, bd, by))
        log(f"p17 K3 on a rank's shard M={m} K={k} N={n}: max|diff|={err:.3e} rel={rel:.3e} "
            f"ulps={ulps:.3f}; {bad}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, F.linear on the "
            f"bf16 block {t_l:.4f} ms, bound {bd:.4f} ms ({by}) [{card}]")
    return rec


def phase_p17(torch, np, dev, card: str) -> dict:
    """Phase 17 (module docstring): tensor parallelism."""
    from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
    from genconvit_tpu_torch.ops.cuda import int8_matmul as k3
    from genconvit_tpu_torch.parallel.dryrun import Ranks

    t = time.perf_counter()
    ranks = Ranks(p17_rank, P17_RANKS).join(timeout=P17_TIMEOUT)
    ranks_s = time.perf_counter() - t
    fails = [f for r in ranks for f in r["fails"]]
    for r in ranks:
        a = r["a"]
        if any(a["counts"].values()):
            fails.append(f"p17a rank {r['index']}: launches {a['counts']} under the default "
                         f"plan (JAX's rule: the plain graph, no kernel)")
        if r["e_bias"] <= P17_TOL:
            fails.append(f"p17e fc2's bias on every rank passed: {r['e_bias']}")
        if r["e_swiglu"] <= P17_TOL:
            fails.append(f"p17e the contiguous SwiGLU split passed: {r['e_swiglu']}")
        if r["e_reduce"] <= P17_GRAD_TOL:
            fails.append(f"p17e all_reduce_sum for reduce_from_model passed: {r['e_reduce']}")
        for m, shape, err, rel, ulps, bad in r["b"]["k3"]:
            log(f"p17b rank {r['index']} K3 on its shard M={m} wq {shape}: max|diff|={err:.3e} "
                f"rel={rel:.3e} ulps={ulps:.3f}; {bad} [{card}]")
    if len({r["d"]["digest"] for r in ranks}) != 1:
        fails.append("p17d the replicated parameters differ across the 'model' ranks")
    if len({r["d"]["loss"] for r in ranks}) != 1:
        fails.append(f"p17d losses differ across ranks: {[r['d']['loss'] for r in ranks]}")
    r0 = ranks[0]
    log(f"p17a [{P17_RANKS} ranks on one card, 1x2 mesh, gloo]: predict_sharded tensor_parallel "
        f"V={P16_V} under the default plan: launches "
        f"{ {k: v for k, v in r0['a']['counts'].items() if v} } (the plain graph); "
        f"max|dy_val| {max(r['a']['dv_plain'] for r in ranks):.3e} against the one-process "
        f"pallas '0' forward, {max(r['a']['dv_default'] for r in ranks):.3e} against the "
        f"one-process default plan (limit {YVAL_TOL}), y equal where decisive [{card}]")
    log(f"p17b int8 heads, V={P17_V['int8']}: K3 launches a rank "
        f"{r0['b']['counts']['matmul_wint8']} = one process {r0['b']['one_k3']}; max|dy_val| {max(r['b']['dv'] for r in ranks):.3e} against the "
        f"one-process int8 forward (limit {YVAL_TOL}) [{card}]")
    for pallas in ("stage", "mlpfull"):
        log(f"p17c pallas {pallas!r}, V={P17_V[pallas]}: launches a rank "
            f"{ {k: v for k, v in r0[pallas]['counts'].items() if v} } = one process; "
            f"max|dy_val| {max(r[pallas]['dv'] for r in ranks):.3e} (limit {P17_TOL}); the "
            f"one-process V=8 forward against its two blocks of 4 (control) "
            f"{r0[pallas]['control']:.3e} [{card}]")
    log(f"p17d float32 DP+TP step N={P16_BATCH} (TF32 off): loss {r0['d']['loss']:.6f} against "
        f"{r0['d']['ref_loss']:.6f} (rel {max(r['d']['dloss'] for r in ranks):.2e}, limit "
        f"{P17_LOSS_TOL}); gradients rel L2 by group, worst of the ranks: "
        + ", ".join(f"{k} {max(r['d']['errs'][k] for r in ranks):.2e}" for k in r0["d"]["errs"])
        + f" (limit {P17_GRAD_TOL}); parameter change rel L2 "
        f"{max(r['d']['change'] for r in ranks):.3e} (limit {P17_CHANGE_TOL}); replicated "
        f"parameters bit-equal across the ranks [{card}]")
    log(f"p17e planted faults caught: fc2's bias on every rank max|dy_val| "
        f"{min(r['e_bias'] for r in ranks):.3e}, the contiguous SwiGLU split "
        f"{min(r['e_swiglu'] for r in ranks):.3e} (limit {P17_TOL}; the correct split "
        f"{max(r['swiglu'] for r in ranks):.3e}), all_reduce_sum for reduce_from_model gradient "
        f"rel L2 {min(r['e_reduce'] for r in ranks):.3e} (limit {P17_GRAD_TOL}) [{card}]")
    log(f"p17 time-sliced on one card (not scaling): predict_sharded tp a call, V={P16_V} "
        f"default plan {max(r['a']['s'] for r in ranks) * 1e3:.1f} ms, V={P17_V['int8']} int8 "
        f"heads {max(r['b']['s'] for r in ranks) * 1e3:.1f} ms, V={P17_V['stage']} 'stage' "
        f"{max(r['stage']['s'] for r in ranks) * 1e3:.1f} ms, V={P17_V['mlpfull']} 'mlpfull' "
        f"{max(r['mlpfull']['s'] for r in ranks) * 1e3:.1f} ms; f32 DP+TP step "
        f"{max(r['d_s'] for r in ranks):.2f} s; peak device memory a rank "
        f"{max(r['peak_gib'] for r in ranks):.2f} GiB; ranks {ranks_s:.1f} s [{card}]")
    k3rec = p17_k3_times(torch, km, k3, dev, card)
    seconds = time.perf_counter() - t
    if fails:
        raise AssertionError("phase 17: " + "; ".join(fails))
    m120 = [s for s in k3rec["shapes"] if s[0] == 120][0]
    return {"ranks": ranks, "k3": k3rec, "seconds": seconds, "ranks_s": ranks_s,
            "tp_k3": r0["b"]["counts"]["matmul_wint8"],
            "record": {"name": f"matmul_wint8[N={LATENT[1] // P17_RANKS}]", "route": "cuda",
                       "source": "genconvit_tpu_torch/csrc/int8_matmul.cu",
                       "replaces": "genconvit_tpu/ops/pallas/int8_matmul.py:30",
                       "launches": 0, "max_abs_err": k3rec["err"], "ms": m120[1],
                       "plain_ms": m120[2], "bound_ms": m120[4], "bound_by": m120[5],
                       "library_ms": m120[3]}}


def p17_summary(p17: dict, card: str) -> None:
    ranks = p17["ranks"]
    k3 = ", ".join(f"M={m} {tk:.4f} ms (plain {tp:.4f}, F.linear {tl:.4f}, bound {bd:.4f} {by})"
                   for m, tk, tp, tl, bd, by in p17["k3"]["shapes"])
    log(f"summary [p17]: {P17_RANKS} gloo ranks on one card, 1x2 mesh: default plan max|dy_val| "
        f"{max(r['a']['dv_default'] for r in ranks):.3e}, int8 heads "
        f"{max(r['b']['dv'] for r in ranks):.3e}, 'stage' {max(r['stage']['dv'] for r in ranks):.3e}, "
        f"'mlpfull' {max(r['mlpfull']['dv'] for r in ranks):.3e}; f32 step loss rel "
        f"{max(r['d']['dloss'] for r in ranks):.2e}, worst gradient group "
        f"{max(max(r['d']['errs'].values()) for r in ranks):.2e}; K3 on a 6272-column shard "
        f"{k3}; peak {max(r['peak_gib'] for r in ranks):.2f} GiB a rank; {p17['seconds']:.1f} s "
        f"[{card}]")


# ---------------------------------------------------------------- phase 18

P18_SAMPLES = 256    # 18b: synth_dataset samples, trained P18_EPOCHS epochs at P18_BATCH
P18_EPOCHS = 2
P18_BATCH = 64
P18_ASSET = ("genconvit_tpu", "assets", "facedet.gcv")   # the committed detector: never written


def p18_faces(np, seed: int, n: int) -> list:
    """n RGB uint8 face crops, 90-199 px a side: a skin-toned ellipse with
    two dark eyes on a noisy background."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(90, 200, 2))
        yy, xx = np.mgrid[0:h, 0:w]
        img = rng.integers(30, 90, (h, w, 3)).astype(np.float32)
        cy, cx = h / 2 + rng.uniform(-5, 5), w / 2 + rng.uniform(-5, 5)
        inside = ((yy - cy) / (0.45 * h)) ** 2 + ((xx - cx) / (0.38 * w)) ** 2 < 1
        img[inside] = np.array([200, 160, 140]) + rng.uniform(-25, 25, 3) \
            + rng.normal(0, 8, (inside.sum(), 3))
        for ex in (-0.15, 0.15):
            eye = (((yy - cy + 0.1 * h) / (0.05 * h)) ** 2
                   + ((xx - cx - ex * w) / (0.08 * w)) ** 2 < 1)
            img[eye] = (40, 30, 30)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def p18_frames(np, seed: int, n: int) -> list:
    """n RGB uint8 video-like frames (180x320, 240x240, 360x640 in turn): blocks
    of colour leaning away from skin, noise, up to two skin-coloured discs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = ((180, 320), (240, 240), (360, 640))[i % 3]
        yy, xx = np.mgrid[0:h, 0:w]
        base = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
        base[..., 2] = np.maximum(base[..., 2], base[..., 0] + 40)
        img = np.repeat(np.repeat(base, 16, 0), 16, 1)[:h, :w] * 0.6 \
            + rng.normal(0, 10, (h, w, 3))
        for _ in range(int(rng.integers(0, 3))):
            r = rng.uniform(0.08, 0.25) * min(h, w)
            cy, cx = rng.uniform(r, h - r), rng.uniform(r, w - r)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            img[disc] = np.array([205, 150, 125]) + rng.normal(0, 6, (disc.sum(), 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def p18_parity(torch, dev, card: str) -> dict:
    """18a: the parity sweep on the kernels, then once with each planted fault."""
    import io

    from genconvit_tpu_torch.ops.cuda import launch_counts
    from genconvit_tpu_torch.tools import onchip_parity as op

    weights = op.make_weights(dev)
    buf = io.StringIO()
    before = launch_counts()
    sweep = op.run(dev, out=buf, weights=weights)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    for line in buf.getvalue().splitlines():
        log(f"  18a {line}")
    if sweep.failures:
        raise AssertionError(f"18a: the sweep failed {sweep.failures}")
    # every fast path a kernel launch: one per check of each kernel
    wrapper = {"K1": "ln_mlp_residual", "K2": "layer_norm_rows", "K3": "matmul_wint8",
               "K4 'fc1'": "ln_mlp_residual_int8", "K4 'full'": "ln_mlp_residual_int8",
               "K5": "fused_convnext_block", "K6": "fused_convnext_stage", "K7": "window_attention"}
    want: dict = {}
    for c in sweep.checks:
        if c.kernel:
            want[wrapper[c.kernel]] = want.get(wrapper[c.kernel], 0) + 1
    if launched != want:
        raise AssertionError(f"18a: kernel launches {launched}, one per check {want}")
    log(f"18a: kernel launches in the sweep {launched} (one per check) [{card}]")
    planted = {}
    for plant, what in op.PLANTS.items():
        bad = op.run(dev, plant, out=io.StringIO(), weights=weights)
        if not bad.failures:
            raise AssertionError(f"18a: the planted fault {plant} ({what}) passed the sweep")
        worst = max(bad.checks, key=lambda c: c.rel / c.tol)
        planted[plant] = worst.rel / worst.tol
        log(f"  18a planted {plant} ({what}): {len(bad.failures)} check(s) failed, worst "
            f"{worst.name} {worst.rel:.3e} ({worst.rel / worst.tol:.2f}x its tolerance) -> refused")
    ratios = op.kernel_ratios(sweep)
    for kernel, rel in sorted(ratios.items()):
        log(f"18a {kernel}: max rel diff against the unfused graph {rel:.3e} [{card}]")
    return {"ratios": ratios, "checks": len(sweep.checks), "planted": planted,
            "gelu": next(c.rel for c in sweep.checks if c.name.startswith("rational_gelu")),
            "folded": max(c.rel for c in sweep.checks if c.name.startswith("folded_block"))}


def p18_facedet(torch, np, dev, card: str, tmp: str) -> dict:
    """18b: synth_dataset over seeded faces and frames in memory (the skin
    weak labels without cv2), the detector trained on the card, evaluated,
    written and read back; the committed detector untouched."""
    import hashlib
    import importlib.util
    import logging
    import math
    import os

    from genconvit_tpu_torch.core.checkpoint import load_checkpoint
    from genconvit_tpu_torch.core.convert import state_dict_from_jax
    from genconvit_tpu_torch.data.faces import SkinDetector
    from genconvit_tpu_torch.models.facedet import FaceDet
    from genconvit_tpu_torch.tools import train_facedet_synth as tfs

    asset = os.path.join(os.path.dirname(os.path.abspath(__file__)), *P18_ASSET)

    def digest():
        with open(asset, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = digest()
    cv2_before = "cv2" in sys.modules
    faces, heldout, frames = p18_faces(np, 1, 12), p18_faces(np, 3, 4), p18_frames(np, 2, 9)
    skin = sum(len(b) for b in SkinDetector().detect(np.stack(frames[1::3])))
    losses = []

    class Losses(logging.Handler):
        def emit(self, record):
            if "mean loss" in record.getMessage():
                losses.append(float(record.getMessage().rsplit(" ", 1)[1]))

    logger = logging.getLogger("genconvit_tpu_torch")
    handler, level = Losses(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        t = time.perf_counter()
        model, miou, det = tfs.train(faces, heldout, frames, n=P18_SAMPLES, epochs=P18_EPOCHS,
                                     batch=P18_BATCH, lr=2e-3, seed=0, device=dev)
        seconds = time.perf_counter() - t
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    if len(losses) != P18_EPOCHS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"18b: epoch losses {losses}")
    if not (0.0 <= miou <= 1.0 and 0.0 <= det <= 1.0):
        raise AssertionError(f"18b: evaluate gave {miou}, {det}")
    path = os.path.join(tmp, "facedet_synth.gcv")
    tfs.save_facedet(path, model, heldout_mean_iou=miou, heldout_det_rate_at_05=det)
    payload = load_checkpoint(path)
    back = FaceDet()
    back.load_state_dict(state_dict_from_jax(payload["params"], "facedet"), strict=True)
    for k, v in model.state_dict().items():
        if not torch.equal(back.state_dict()[k], v.cpu()):
            raise AssertionError(f"18b: {k} read back differs")
    if payload["extra"]["kind"] != "facedet":
        raise AssertionError(f"18b: extra {payload['extra']}")
    if digest() != before:
        raise AssertionError("18b: the committed genconvit_tpu/assets/facedet.gcv changed")
    if not cv2_before and "cv2" in sys.modules:
        raise AssertionError("18b: the synthetic data or the skin detector imported cv2")
    cv2 = importlib.util.find_spec("cv2") is not None
    log(f"18b: {P18_SAMPLES} synthetic samples, {P18_EPOCHS} epochs at batch {P18_BATCH} on the "
        f"card: epoch losses {', '.join(f'{v:.4f}' for v in losses)}; evaluate mean IoU {miou:.4f}, "
        f"det-rate@0.5 {det:.4f}; {skin} skin box(es) on 3 frames; cv2 not imported (installed "
        f"here: {cv2}); the .gcv read back equal; the committed detector unchanged; "
        f"{seconds:.1f} s [{card}]")
    return {"losses": losses, "miou": miou, "det": det, "seconds": seconds}


def p18_summary_total(torch) -> dict:
    """18c: the published configuration's model_summary TOTAL (on the meta
    device: no memory)."""
    from genconvit_tpu_torch.config import Config
    from genconvit_tpu_torch.models.genconvit import GenConViT
    from genconvit_tpu_torch.utils.summary import model_summary

    with torch.device("meta"):
        model = GenConViT(Config())
    line = model_summary(model).splitlines()[-1].split()
    total, mb = int(line[1].replace(",", "")), float(line[2])
    params = sum(p.numel() for p in model.parameters())
    stats = sum(b.numel() for n, b in model.named_buffers() if n.endswith(("running_mean",
                                                                          "running_var")))
    if total != params + stats:
        raise AssertionError(f"18c: TOTAL {total} != {params} parameters + {stats} BatchNorm "
                             f"statistics")
    log(f"18c: model_summary of GenConViT (convnext_tiny, 224 px, both branches): TOTAL {total:,} "
        f"({mb:.1f} MB) = {params:,} parameters + {stats:,} BatchNorm running statistics (the JAX "
        f"tree holds them as 'mean' and 'var')")
    return {"total": total, "params": params, "stats": stats}


def phase_p18(torch, np, dev, card: str, tmp: str) -> dict:
    """Phase 18 (module docstring): the parity sweep, the detector's synthetic
    data and training tools, model_summary."""
    t = time.perf_counter()
    out = {"a": p18_parity(torch, dev, card)}
    out["a_seconds"] = time.perf_counter() - t
    out["b"] = p18_facedet(torch, np, dev, card, tmp)
    out["c"] = p18_summary_total(torch)
    out["seconds"] = time.perf_counter() - t
    return out


def p18_summary(p18: dict, card: str) -> None:
    a, b = p18["a"], p18["b"]
    log(f"summary [p18]: {a['checks']} parity checks passed against the unfused graph, kernels "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(a["ratios"].items()))
        + f", LN-folded block {a['folded']:.3e}, GELU {a['gelu']:.3e}; {len(a['planted'])} planted "
        f"faults refused ({min(a['planted'].values()):.2f}-{max(a['planted'].values()):.2f}x "
        f"their tolerance); detector: mean IoU {b['miou']:.4f}, det-rate {b['det']:.4f}; "
        f"TOTAL {p18['c']['total']:,}; sweep {p18['a_seconds']:.1f} s, phase {p18['seconds']:.1f} s "
        f"[{card}]")


# ---------------------------------------------------------------- phase 19

P19_SEED = 19
P19_V = 8             # 19c: the batch both weight files' Predictors score
P19_AB_TOL = 1e-5     # 19d: the two arch types' preds (the same graph, B12)


def p19_pth(torch, np, dev, wdir: str) -> dict:
    """19a: seeded reference-keyed `.pth` files of the published
    configuration with every dead group (`convert_weights.published_layout`):
    the live weights of `seeded_weights`, whose keys and shapes must be the
    layout's without the dead groups, and the dead groups drawn on the host
    (a whole swin_tiny embedder, timm's buffers, the HybridEmbed's second
    registration of the same tensors, its proj, the VAE's encoder.fc1/fc2
    and fc3). The ED bare, the VAE nested under 'state_dict'."""
    import os

    from genconvit_tpu_torch.convert_weights import published_layout

    cfg = backbone_config("convnext_tiny")
    live = seeded_weights(torch, dev, P19_SEED)
    g = torch.Generator().manual_seed(P19_SEED)
    out = {"live": live, "paths": {}, "dead": {}}
    for branch in ("ed", "vae"):
        t = time.perf_counter()
        layout = published_layout(branch, cfg)
        lean = published_layout(branch, cfg, dead=False)
        sd = dict(live[branch])
        bad = [k for k in set(sd) | set(lean)
               if k not in sd or k not in lean or sd[k].shape != lean[k].shape]
        if bad:
            raise AssertionError(f"19a: the {branch} module's state dict is not the published "
                                 f"layout at {sorted(bad)[:5]}")
        alias = "backbone.patch_embed.backbone." if branch == "ed" else \
            "convnext_backbone.patch_embed.backbone."
        for k, v in layout.items():
            if k in sd or k.startswith(alias):
                continue
            if v.dtype == torch.long:
                sd[k] = torch.zeros(v.shape, dtype=torch.long)
            else:
                sd[k] = torch.randn(v.shape, generator=g) * 0.02
        for k in layout:
            if k.startswith(alias):
                sd[k] = sd["embedder." + k[len(alias):]]
        if set(sd) != set(layout):
            raise AssertionError(f"19a: {branch} keys differ from the published layout")
        path = os.path.join(wdir, f"genconvit_{branch}_inference.pth")
        torch.save(sd if branch == "ed" else {"epoch": 1, "state_dict": sd, "min_loss": 0.5},
                   path)
        out["paths"][branch] = path
        out["dead"][branch] = len(layout) - len(lean)
        out[f"{branch}_sd"] = sd
        log(f"p19 [weights]: {branch} .pth of the published layout, {len(layout)} keys ({len(lean)} "
            f"live, {len(layout) - len(lean)} dead incl. timm's buffers and the HybridEmbed "
            f"aliases), {os.path.getsize(path) / 2**20:.1f} MiB, "
            f"{time.perf_counter() - t:.2f} s")
    return out


def p19_convert(torch, tmp: str, w: dict, card: str) -> dict:
    """19b: `python -m genconvit_tpu_torch.convert_weights` as subprocesses,
    all at once (host I/O; no card visible to them): --strict with and
    without --no-dead on both files, and --preflight --expect-init on both
    files' manifests (with --no-dead too for the VAE), which must exit 0,
    and on a VAE manifest whose latent heads drifted to 8192, which must
    exit 1."""
    import os

    from genconvit_tpu_torch.core.convert import manifest_from_state_dict

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
    dirs = {"gcv": os.path.join(tmp, "gcv"), "no_dead": os.path.join(tmp, "no_dead")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    manifests = {}
    for branch in ("ed", "vae"):
        m = manifest_from_state_dict(w[f"{branch}_sd"])
        manifests[branch] = os.path.join(tmp, f"manifest_{branch}.json")
        with open(manifests[branch], "w") as f:
            json.dump(m, f)
        if branch == "vae":
            for head in ("mu", "var"):
                m[f"encoder.{head}.weight"]["shape"][0] = 8192
                m[f"encoder.{head}.bias"]["shape"][0] = 8192
            manifests["drifted"] = os.path.join(tmp, "manifest_drifted.json")
            with open(manifests["drifted"], "w") as f:
                json.dump(m, f)
    cli = [sys.executable, "-m", "genconvit_tpu_torch.convert_weights"]
    jobs = {}
    for branch in ("ed", "vae"):
        pth = w["paths"][branch]
        name = f"genconvit_{branch}_inference.gcv"
        jobs[f"{branch} --strict"] = (cli + [pth, "--strict", "--out",
                                             os.path.join(dirs["gcv"], name)], 0)
        jobs[f"{branch} --no-dead --strict"] = (cli + [pth, "--no-dead", "--strict", "--out",
                                                       os.path.join(dirs["no_dead"], name)], 0)
        jobs[f"preflight {branch}"] = (cli + ["--preflight", manifests[branch],
                                              "--expect-init"], 0)
    jobs["preflight vae --no-dead"] = (cli + ["--preflight", manifests["vae"], "--expect-init",
                                              "--no-dead"], 0)
    jobs["preflight drifted"] = (cli + ["--preflight", manifests["drifted"], "--expect-init"], 1)
    t = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, (cmd, _) in jobs.items()}
    res = {}
    try:
        for k, p in procs.items():
            out, err = p.communicate(timeout=600)
            res[k] = (p.returncode, out, err)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.perf_counter() - t
    for k, (code, out, err) in res.items():
        want = jobs[k][1]
        last = out.strip().splitlines()[-1] if out.strip() else ""
        if code != want:
            raise AssertionError(f"19b: convert_weights {k}: exit {code}, want {want}\n"
                                 f"{out[-2000:]}\n{err[-2000:]}")
        if k.startswith("preflight"):
            report = json.loads(out[:out.rindex("}") + 1])
            ok = last.startswith("PREFLIGHT OK")
            if ok != (want == 0) or report["ok"] != ok:
                raise AssertionError(f"19b: {k}: {last!r}, report ok {report['ok']}")
            if k == "preflight drifted" and not any(
                    m.startswith("encoder/mu/kernel: checkpoint") and ", 8192) vs" in m
                    for m in report["shape_mismatches"]):
                raise AssertionError(f"19b: the drifted heads were not named: {report}")
            last = last if ok else f"{report['error']}: {report['shape_mismatches'][:2]}"
        log(f"p19 [convert_weights {k}]: exit {code}: {last}")
    log(f"p19 [convert_weights]: {len(jobs)} runs in parallel, {dt:.1f} s wall [{card}]")
    return {"dirs": dirs, "seconds": dt}


def p19_files(torch, w: dict, dirs: dict) -> dict:
    """19c, continued: each branch's state dict from the carrying `.gcv`,
    the --no-dead one and the `.pth`, tensor for tensor equal to the
    written live weights; the dead groups in the carrying tree only."""
    import os

    from genconvit_tpu_torch.core.checkpoint import load_checkpoint, load_params
    from genconvit_tpu_torch.core.convert import state_dict_from_jax

    sds = {"gcv": {}, "pth": {}}
    for branch in ("ed", "vae"):
        name = f"genconvit_{branch}_inference.gcv"
        t = time.perf_counter()
        carried = load_checkpoint(os.path.join(dirs["gcv"], name))
        dead = {"embedder", "hybrid_proj"} | ({"fc3"} if branch == "vae" else set())
        if not dead <= set(carried["params"]) or carried["extra"] != {
                "source": os.path.basename(w["paths"][branch]), "branch": branch}:
            raise AssertionError(f"19c: {branch} .gcv params {sorted(carried['params'])}, "
                                 f"extra {carried['extra']}")
        sds["gcv"][branch] = state_dict_from_jax(carried["params"], branch)
        del carried
        t_gcv = time.perf_counter() - t
        lean = load_checkpoint(os.path.join(dirs["no_dead"], name))["params"]
        if dead & set(lean):
            raise AssertionError(f"19c: the --no-dead {branch} .gcv holds {dead & set(lean)}")
        lean = state_dict_from_jax(lean, branch)
        t = time.perf_counter()
        sds["pth"][branch] = load_params(w["paths"][branch], branch)[0]
        t_pth = time.perf_counter() - t
        want = w["live"][branch]
        for what, sd in (("gcv", sds["gcv"][branch]), ("no-dead gcv", lean),
                         ("pth", sds["pth"][branch])):
            bad = [k for k in want if k not in sd or not torch.equal(sd[k], want[k])]
            if bad or set(sd) != set(want):
                raise AssertionError(f"19c: {branch} {what} differs from the written weights at "
                                     f"{bad[:5]}")
        os.remove(os.path.join(dirs["no_dead"], name))
        log(f"p19 [load]: {branch}: the .gcv (dead groups carried), the --no-dead .gcv and the "
            f".pth give the written {len(want)} tensors; .gcv read {t_gcv:.2f} s, .pth "
            f"load_params {t_pth:.2f} s")
    return sds


def p19_predictors(torch, np, dev, card: str, sds: dict) -> dict:
    """19c: a Predictor from each file's weights, under the default plan and
    under int8 heads, scoring one seeded V=8 batch with masked frames:
    y_val equal bit for bit, each forward's launches counted (54 K1 + 3 K2,
    + 1 K3)."""
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops import cuda as kcuda

    rng = np.random.default_rng(P19_SEED)
    faces = rng.integers(0, 256, (P19_V, FRAMES, IMG, IMG, 3), dtype=np.uint8)
    mask = np.ones((P19_V, FRAMES), np.float32)
    mask[1, 5:] = mask[6, 11:] = 0
    out = {}
    for plan_name, int8_heads in (("default", False), ("int8_heads", True)):
        want = expected_launches(kcuda, "", "", int8_heads)
        got = {}
        for src in ("gcv", "pth"):
            pred = Predictor(backbone_config("convnext_tiny"), device=dev, params=sds[src],
                             kernel_plan=make_plan("", "", int8_heads), deterministic_vae=True,
                             face_backend="center")
            kcuda.reset_launch_counts()
            t = time.perf_counter()
            y, y_val = pred.predict_videos_batched(faces, mask)
            dt = time.perf_counter() - t
            counts = kcuda.launch_counts()
            del pred
            torch.cuda.empty_cache()
            check_verdicts(np, np.asarray(y), np.asarray(y_val, np.float64), P19_V)
            if counts != want:
                raise AssertionError(f"19c [{plan_name}] {src}: launches {counts}, want {want}")
            got[src] = (np.asarray(y), np.asarray(y_val))
            log(f"p19 [{plan_name}] {src}: y={got[src][0].tolist()} "
                f"y_val={np.round(got[src][1], 5).tolist()} ({dt:.2f} s, launches "
                f"{ {k: v for k, v in counts.items() if v} }) [{card}]")
        if not (np.array_equal(got["gcv"][0], got["pth"][0])
                and np.array_equal(got["gcv"][1], got["pth"][1])):
            raise AssertionError(f"19c [{plan_name}]: the .gcv's verdicts {got['gcv']} != the "
                                 f".pth's {got['pth']}")
        out[plan_name] = {k: v for k, v in kcuda.launch_counts().items() if v}
    return out


def p19_ab(np, tmp: str, corpus: dict, gcv_dir: str, card: str) -> dict:
    """19d: `run_benchmark.main` in-process over placeholder files of the
    corpus (names with and without 'fake', one that does not decode) with
    phase 12's in-memory decoder and the `.gcv` weights by name: both
    result JSONs, the same names and labels, preds within P19_AB_TOL; the
    comparison written where matplotlib is installed, its ImportError
    (after both runs) where it is not."""
    import glob
    import importlib.util
    import os

    from genconvit_tpu_torch import run_benchmark
    from genconvit_tpu_torch.infer import engine

    vdir, out_dir = os.path.join(tmp, "ab_videos"), os.path.join(tmp, "ab_result")
    os.makedirs(vdir)
    for i, n in enumerate(sorted(corpus) + ["broken.mp4"]):
        with open(os.path.join(vdir, f"fake_{n}" if i % 2 == 0 else n), "w") as f:
            f.write(n)
    argv = [vdir, str(FRAMES), out_dir, "--face-backend", "jax", "--weights-dir", gcv_dir]
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    decode = engine.extract_frames
    engine.extract_frames = memory_decoder(corpus)
    t = time.perf_counter()
    try:
        if have_mpl:
            artifacts = run_benchmark.main(argv)["artifacts"]
        else:
            try:
                run_benchmark.main(argv)
                raise AssertionError("19d: the comparison ran without matplotlib")
            except ImportError:
                artifacts = None
    finally:
        engine.extract_frames = decode
    dt = time.perf_counter() - t
    paths = sorted(glob.glob(os.path.join(out_dir, "prediction_*.json")))
    videos = []
    for arch, path in zip(("original", "v2"), paths):
        if f"_genconvit_{arch}_" not in os.path.basename(path):
            raise AssertionError(f"19d: result files {paths}")
        with open(path) as f:
            videos.append(json.load(f)["video"])
    if len(videos) != 2:
        raise AssertionError(f"19d: result files {paths}")
    a, b = videos
    labels = ["FAKE" if "fake" in n.lower() else "REAL" for n in a["name"]]
    dp = float(np.abs(np.asarray(a["pred"]) - np.asarray(b["pred"])).max())
    if a["name"] != b["name"] or len(a["name"]) != len(corpus) + 1 \
            or a["pred_label"] != b["pred_label"] or a["correct_label"] != labels \
            or b["correct_label"] != labels or dp > P19_AB_TOL \
            or not np.all(np.isfinite(a["pred"])):
        raise AssertionError(f"19d: original {list(zip(a['name'], a['pred']))} vs v2 "
                             f"{b['pred']} (max|d| {dp}, limit {P19_AB_TOL})")
    if have_mpl:
        missing = [k for k in ("csv", "report") if not os.path.isfile(artifacts[k])]
        if missing:
            raise AssertionError(f"19d: comparison artifacts missing: {missing}")
        comparison = f"run: {sorted(artifacts)}"
    else:
        comparison = "absent (matplotlib is not installed)"
    log(f"p19 [run_benchmark]: both arch types over {len(a['name'])} placeholder files "
        f"{dt:.2f} s; max|d pred| {dp:.3e} (limit {P19_AB_TOL}); labels {a['pred_label']}; "
        f"comparison {comparison} [{card}]")
    return {"dp": dp, "seconds": dt, "comparison": comparison}


def phase_p19(torch, np, dev, card: str, tmp: str, corpus: dict) -> dict:
    """Phase 19 (module docstring): the weight converter CLI and the A/B
    runner. Its files live in tmp/p19, removed at the end."""
    import os
    import shutil

    t0 = time.perf_counter()
    wdir = os.path.join(tmp, "p19")
    os.makedirs(wdir)
    try:
        w = p19_pth(torch, np, dev, wdir)
        t = time.perf_counter()
        conv = p19_convert(torch, wdir, w, card)
        sds = p19_files(torch, w, conv["dirs"])
        del w
        launches = p19_predictors(torch, np, dev, card, sds)
        del sds
        t_c = time.perf_counter() - t
        ab = p19_ab(np, wdir, corpus, conv["dirs"]["gcv"], card)
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    return {"launches": launches, "convert_s": conv["seconds"], "bc_s": t_c, "ab": ab,
            "seconds": time.perf_counter() - t0}


def p19_summary(p19: dict, card: str) -> None:
    log(f"summary [p19]: convert_weights --strict (carrying and --no-dead) and 4 preflights "
        f"{p19['convert_s']:.1f} s wall; the .gcv and the .pth equal to the written weights, "
        f"y_val equal bit for bit (default plan {p19['launches']['default']}, int8 heads "
        f"{p19['launches']['int8_heads']}); run_benchmark {p19['ab']['seconds']:.1f} s, max|d pred| "
        f"{p19['ab']['dp']:.3e}, comparison {p19['ab']['comparison']}; phase "
        f"{p19['seconds']:.1f} s [{card}]")


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
    ap.add_argument("--phase15-only", action="store_true",
                    help="phases 1, 2 and 15 alone (no result lines): the fullframe fast "
                         "paths (YUV420 conversion and forward, the stream, the drivers)")
    ap.add_argument("--phase16-only", action="store_true",
                    help="phases 1, 2 and 16 alone (no result lines): data parallelism on "
                         "torch.distributed (NCCL world 1, then two gloo ranks on the card)")
    ap.add_argument("--phase17-only", action="store_true",
                    help="phases 1, 2 and 17 alone (no result lines): tensor parallelism "
                         "(two gloo ranks on the card, a 1x2 mesh)")
    ap.add_argument("--phase18-only", action="store_true",
                    help="phases 1, 2 and 18 alone (no result lines): the parity sweep against "
                         "the unfused graph, the detector's synthetic data and training, "
                         "model_summary")
    ap.add_argument("--phase19-only", action="store_true",
                    help="phases 1, 2 and 19 alone (no result lines): the weight converter CLI "
                         "on full-size seeded weights and the A/B runner")
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
    if args.phase15_only:
        with tempfile.TemporaryDirectory(prefix="gcv_p15_") as tmp:
            t = time.perf_counter()
            p15_summary(phase_p15(torch, np, dev, card, tmp), card)
            log(f"phase 15: {time.perf_counter() - t:.1f} s")
        log(f"chip_smoke --phase15-only: phase 15 passed in {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.phase16_only:
        with tempfile.TemporaryDirectory(prefix="gcv_p16_") as tmp:
            t = time.perf_counter()
            p16_summary(phase_p16(torch, np, dev, card, tmp), card)
            log(f"phase 16: {time.perf_counter() - t:.1f} s")
        log(f"chip_smoke --phase16-only: phase 16 passed in {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.phase17_only:
        t = time.perf_counter()
        p17_summary(phase_p17(torch, np, dev, card), card)
        log(f"phase 17: {time.perf_counter() - t:.1f} s")
        log(f"chip_smoke --phase17-only: phase 17 passed in {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.phase18_only:
        with tempfile.TemporaryDirectory(prefix="gcv_p18_") as tmp:
            t = time.perf_counter()
            p18_summary(phase_p18(torch, np, dev, card, tmp), card)
            log(f"phase 18: {time.perf_counter() - t:.1f} s")
        log(f"chip_smoke --phase18-only: phase 18 passed in {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.phase19_only:
        with tempfile.TemporaryDirectory(prefix="gcv_p19_") as tmp:
            t = time.perf_counter()
            p19_summary(phase_p19(torch, np, dev, card, tmp, video_corpus(np)), card)
            log(f"phase 19: {time.perf_counter() - t:.1f} s")
        log(f"chip_smoke --phase19-only: phase 19 passed in {time.perf_counter() - t_all:.1f} s")
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
        corpus = video.pop("corpus")
        serving = phase_serve(torch, np, dev, card, tmp, corpus)
        log(f"phase 12: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        p14 = phase_p14(torch, np, dev, card, args.profile)
        log(f"phase 14: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        p15 = phase_p15(torch, np, dev, card, tmp)
        log(f"phase 15: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        p16 = phase_p16(torch, np, dev, card, tmp)
        log(f"phase 16: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        p17 = phase_p17(torch, np, dev, card)
        kernels.append(p17["record"])
        log(f"phase 17: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        p18 = phase_p18(torch, np, dev, card, tmp)
        log(f"phase 18: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        p19 = phase_p19(torch, np, dev, card, tmp, corpus)
        log(f"phase 19: {time.perf_counter() - t:.1f} s")
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
    p15_summary(p15, card)
    p16_summary(p16, card)
    p17_summary(p17, card)
    p18_summary(p18, card)
    p19_summary(p19, card)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_all:.1f} s [{card}]")
    # each kernel's launches: the count of the run whose main path runs it
    # (the counts were set to 0 just before its requests)
    source_run = {"ln_mlp_residual": "default", "layer_norm_rows": "default",
                  "matmul_wint8": "int8_heads",
                  "ln_mlp_residual_int8[fc1]": "int8_mlp=fc1",
                  "ln_mlp_residual_int8[full]": "int8_heads+full",
                  "fused_convnext_block": "pallas=1", "fused_convnext_stage": "pallas=stage",
                  "window_attention": "swin", "dots_bf16": "probes", "dots_int8": "probes",
                  "block_parts": "probes", "dw_moments": "probes",
                  p17["record"]["name"]: "tp_int8_heads"}
    counts = {name: r["launches"] for name, r in runs.items()}
    counts["tp_int8_heads"] = {"matmul_wint8": p17["tp_k3"]}
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
