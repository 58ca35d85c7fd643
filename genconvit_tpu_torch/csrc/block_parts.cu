// Hand-written Hopper (sm_90a) probe kernel: K5's block (block_wgmma.cuh)
// cut after one of its phases, with a plain C interface loaded through
// ctypes (genconvit_tpu_torch/ops/cuda/block_parts.py). No PyTorch headers.
//
// M2  gcv_block_parts  replaces the Pallas kernel `kern` of
//     tools/microbench_kernel_parts.py (built by its build(); pallas_call at
//     :104), the fused ConvNeXt block compiled at a growing `phase`
//     (:62-99). Each phase writes [N, H, W, C] bf16 (block_wgmma.cuh,
//     BlockStop):
//
//       dma         x's rows read as the taps read them, written out
//       dw          bf16 of the depthwise 7x7 + bias, f32 sums (the taps'
//                   prologue in its width form: quads, pairs or twice)
//       dw_bf16acc  the same with the bias and every product and sum in bf16
//                   (the tool's fp32dw=False), no fused multiply-add
//       ln          the prologue's y (the one-pass LayerNorm with its
//                   affine, eps 1e-6) written out instead of to the y tiles
//       fc1         the first C columns of bf16(y . w1 + b1), the whole 4C
//                   hidden computed, no fc2 weights streamed
//       gelu        the first C columns of bf16(GELU(y . w1 + b1))
//       full        the block output, bf16(x + (h . w2 + b2) * gamma)
//
//     The time deltas between phases attribute K5's time to its steps: the
//     taps, the LayerNorm, fc1, the GELU, fc2 with the epilogue. Every
//     phase runs K5's schedule (persistent blocks of two consumer
//     warpgroups and a producer, a work item one row tile of K5's plan, the
//     plan's shared memory) up to its cut, so that the deltas add up to
//     K5's time. C up to 1536, K5's widths.
//     GELU: the tool's is convnext_stage._gelu_f32 with exact_div=False,
//     e = zc * P * (1 / Q) with the TPU's approximate reciprocal and one
//     Newton step (genconvit_tpu/ops/pallas/common.py:37-42); here K6's
//     GeluHp<1> computes that form with the correctly rounded reciprocal,
//     its polynomials on fused multiply-adds. That is the one difference
//     between 'full' and K5 (zc * (P / Q)).
//     Weights: the tool's depthwise weights are f32; the probe reads K5's
//     pack, whose depthwise weights are bf16 (convnext_block.FusedBlockWeights),
//     so that it times K5's own taps; the tests feed the JAX side
//     bf16-representable f32 weights, on which the two compute the same.
//     What bounds it on the card: the two matmuls and the 49 f32 taps, as
//     for K5 (convnext_block.cu).
//     The cuts before the MLP (this file) stream no weights; fc1 and gelu
//     (block_parts_hidden.cu) and full (block_parts_full.cu) are built in
//     their own translation units so that their instantiations, one per
//     (rows, NC, stream, pairs) of K5's plans, build in parallel.
//
// The entry point returns cudaGetLastError() after its launch.

#include "block_wgmma.cuh"

extern "C" int gcv_block_parts_hidden(const void* x, const void* wdw, const void* bdw,
                                      const void* lns, const void* lnb, const void* w1t,
                                      const void* b1, const void* w2t, const void* b2,
                                      const void* gamma, void* out, int n, int h, int w, int c,
                                      int gelu, void* stream);
extern "C" int gcv_block_parts_full(const void* x, const void* wdw, const void* bdw,
                                    const void* lns, const void* lnb, const void* w1t,
                                    const void* b1, const void* w2t, const void* b2,
                                    const void* gamma, void* out, int n, int h, int w, int c,
                                    void* stream);

extern "C" {

// M2. x and out [n, h, w, c] bf16 NHWC, the weights K5's pack (w1t [4c, c]
// = fc1.weight, w2t [c, 4c] = fc2.weight); c one gcv_k5_plan takes; phase
// 0..6 = dma, dw, dw_bf16acc, ln, fc1, gelu, full (the caller checks).
int gcv_block_parts(const void* x, const void* wdw, const void* bdw, const void* lns,
                    const void* lnb, const void* w1t, const void* b1, const void* w2t,
                    const void* b2, const void* gamma, void* out, int n, int h, int w, int c,
                    int phase, void* stream) {
  if (phase == kStopFc1 || phase == kStopGelu) {
    return gcv_block_parts_hidden(x, wdw, bdw, lns, lnb, w1t, b1, w2t, b2, gamma, out, n, h, w,
                                  c, phase == kStopGelu, stream);
  }
  if (phase == kStopFull) {
    return gcv_block_parts_full(x, wdw, bdw, lns, lnb, w1t, b1, w2t, b2, gamma, out, n, h, w, c,
                                stream);
  }
  if (static_cast<long long>(n) * h * w <= 0) return static_cast<int>(cudaGetLastError());
  const MlpPlan p = mlp_wgmma_plan(c);
  if (p.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const BlockArgs a = parts_args(x, wdw, bdw, lns, lnb, b1, b2, gamma, out, n, h, w, c, p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case kStopDma: return launch_prologue_cut<kStopDma>(a, w1t, w2t, p, s);
    case kStopDw: return launch_prologue_cut<kStopDw>(a, w1t, w2t, p, s);
    case kStopDwBf16: return launch_prologue_cut<kStopDwBf16>(a, w1t, w2t, p, s);
    case kStopLn: return launch_prologue_cut<kStopLn>(a, w1t, w2t, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
