// Hand-written Hopper (sm_90a) probe kernel: the block tile of K5's first
// design (fused_block.cuh, mlp_tile.cuh) cut after one of its phases, with
// a plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/block_parts.py). No PyTorch headers.
//
// M2  gcv_block_parts  replaces the Pallas kernel `kern` of
//     tools/microbench_kernel_parts.py (built by its build(); pallas_call at
//     :104), the fused ConvNeXt block compiled at a growing `phase`
//     (:62-99). Each phase writes [N, H, W, C] bf16 (fused_block.cuh,
//     TileStop):
//
//       dma         x copied through the tile
//       dw          bf16 of the depthwise 7x7 + bias, f32 sums
//       dw_bf16acc  the same with the bias and every product and sum in bf16
//                   (the tool's fp32dw=False)
//       ln          bf16 of the one-pass LayerNorm with its affine (eps 1e-6)
//       fc1         the first C columns of bf16(y . w1 + b1), the whole 4C
//                   hidden computed
//       gelu        the first C columns of bf16(GELU(y . w1 + b1))
//       full        the block output, bf16(x + (h . w2 + b2) * gamma)
//
//     The time deltas between phases attribute the tile's time to its
//     steps: the question, for K5's first design, was in which step it lost
//     to cuDNN's depthwise conv + K1 at C=192 and at 112 px (PERF.md). Every
//     phase launches that design's grid (BM-row tiles, 8 warps) and runs its
//     tile code up to its cut.
//     GELU: the tool's is convnext_stage._gelu_f32 with exact_div=False,
//     e = zc * P * (1 / Q) with the TPU's approximate reciprocal and one
//     Newton step (genconvit_tpu/ops/pallas/common.py:37-42). The port's
//     GeluRecip (K6's GELU) computes that form with an exact reciprocal, so
//     the probe uses GeluRecip, not K5's GeluErfDiv (zc * (P / Q)).
//     Weights: the tool's depthwise weights are f32; the probe reads K5's
//     pack, whose depthwise weights are bf16 (convnext_block.FusedBlockWeights),
//     so that it times the tile's own taps; the tests feed the JAX side
//     bf16-representable f32 weights, on which the two compute the same.
//     What bounds it on the card: the two matmuls and the 49 f32 taps, as
//     for K5 (convnext_block.cu).
//     The cut phases skip what follows them; fc1 and gelu stream no fc2
//     weight slices.
//
// The entry point returns cudaGetLastError() after its launch.

#include "fused_block.cuh"

namespace {

struct ActNone {   // fc1: the hidden before GELU
  __device__ __forceinline__ float operator()(float h) const { return h; }
};

template <int BM, int Stop>
__global__ void __launch_bounds__(kThreads, 2)
block_parts_kernel(const BlockWeights p, const bf16* x, bf16* out, long long rows, int h, int w,
                   int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const long long row_end = row0 + BM < rows ? row0 + BM : rows;
  if constexpr (Stop == kStopFc1) {
    fused_block_tile<BM, ActNone, Stop>(smem, p, 0, x, out, row0, row_end, h, w, c, ActNone{});
  } else {
    fused_block_tile<BM, GeluRecip, Stop>(smem, p, 0, x, out, row0, row_end, h, w, c,
                                          GeluRecip{});
  }
}

template <int BM, int Stop>
int launch_parts(const BlockWeights& p, const bf16* x, bf16* out, long long rows, int h, int w,
                 int c, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = mlp_smem(c, BM).total;
  const int err = raise_smem_limit(block_parts_kernel<BM, Stop>, smem, &smem_configured);
  if (err) return err;
  const long long blocks = (rows + BM - 1) / BM;
  block_parts_kernel<BM, Stop><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      p, x, out, rows, h, w, c);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_phase(int phase, const BlockWeights& p, const bf16* x, bf16* out, long long rows,
                 int h, int w, int c, cudaStream_t s) {
  switch (phase) {
    case kStopDma: return launch_parts<BM, kStopDma>(p, x, out, rows, h, w, c, s);
    case kStopDw: return launch_parts<BM, kStopDw>(p, x, out, rows, h, w, c, s);
    case kStopDwBf16: return launch_parts<BM, kStopDwBf16>(p, x, out, rows, h, w, c, s);
    case kStopLn: return launch_parts<BM, kStopLn>(p, x, out, rows, h, w, c, s);
    case kStopFc1: return launch_parts<BM, kStopFc1>(p, x, out, rows, h, w, c, s);
    case kStopGelu: return launch_parts<BM, kStopGelu>(p, x, out, rows, h, w, c, s);
    case kStopFull: return launch_parts<BM, kStopFull>(p, x, out, rows, h, w, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// M2. x and out [n, h, w, c] bf16 NHWC, the weights K5's pack; c a multiple
// of 32, at most 768; phase 0..6 = dma, dw, dw_bf16acc, ln, fc1, gelu, full
// (the caller checks).
int gcv_block_parts(const void* x, const void* wdw, const void* bdw, const void* lns,
                    const void* lnb, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* gamma, void* out, int n, int h, int w, int c,
                    int phase, void* stream) {
  const long long rows = static_cast<long long>(n) * h * w;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  BlockWeights p;
  p.wdw = static_cast<const bf16*>(wdw);
  p.bdw = static_cast<const float*>(bdw);
  p.lns = static_cast<const float*>(lns);
  p.lnb = static_cast<const float*>(lnb);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  const bf16* xs = static_cast<const bf16*>(x);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mlp_row_tile(c)) {
    case 64: return launch_phase<64>(phase, p, xs, o, rows, h, w, c, s);
    case 32: return launch_phase<32>(phase, p, xs, o, rows, h, w, c, s);
    default: return launch_phase<16>(phase, p, xs, o, rows, h, w, c, s);
  }
}

}  // extern "C"
