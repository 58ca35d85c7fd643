// Hand-written Hopper (sm_90a) kernel for one whole ConvNeXt block, with a
// plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/convnext_block.py). No PyTorch headers.
//
// K5  gcv_fused_block  replaces the Pallas kernel _block_kernel of
//     genconvit_tpu/ops/pallas/convnext_block.py (entry fused_convnext_block):
//     depthwise 7x7 + bias -> LayerNorm -> fc1 -> GELU (hp rational erf,
//     exact divide, whatever the plan's tier) -> fc2 -> layer scale ->
//     residual, on an NHWC bf16 activation, the math of fused_block.cuh.
//     What bounds it on the card: by the published peaks, the two matmuls
//     (16*R*C^2 bf16 operations) and the 49 f32 taps (98*R*C operations at
//     67 TFLOP/s), which at C=96 weigh about the same; the bytes (x in, out
//     out, 4*C bytes a row) are below both. In practice it inherits K1's
//     per-iteration overhead (fragment loads, barriers, copy latency; see
//     convnext_mlp.cu) and adds the taps, whose loads and address
//     arithmetic, not their flops, set their cost: a loop that paid two
//     loads per tap made K5 1.6x cuDNN's depthwise conv + K1 (PERF.md).
//     What the design does: the conv output and the [R, 4C] hidden never
//     reach device memory, so a block costs one read and one write of the
//     activation (cuDNN's depthwise conv + K1 move it three times more:
//     conv in, conv out, K1's two inputs). A thread block owns BM = 64/32/16
//     consecutive pixels (C up to 192/384/768; K1's row tile) of the
//     flattened [N*H*W] rows. Each warp slides a window along its BM/8
//     pixels of one image row, so that a tap costs about one fused
//     multiply-add per channel pair; the f32 sums go to shared memory, the
//     LayerNorm writes the bf16 y beside them, and K1's fc1 -> GELU -> fc2
//     loop (MlpTile) runs on the unfolded weights; the epilogue adds the
//     bias, the layer scale and the residual. The 128-lane channel padding
//     and the 8-aligned W padding of the TPU kernel are Mosaic layout and
//     not here.
//
// The entry point returns cudaGetLastError() after its launch.

#include "fused_block.cuh"

namespace {

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
fused_block_kernel(const BlockWeights p, const bf16* x, bf16* out, long long rows, int h,
                   int w, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const long long row_end = row0 + BM < rows ? row0 + BM : rows;
  fused_block_tile<BM>(smem, p, 0, x, out, row0, row_end, h, w, c, GeluErfDiv{});
}

template <int BM>
int launch_block(const BlockWeights& p, const bf16* x, bf16* out, long long rows, int h,
                 int w, int c, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = mlp_smem(c, BM).total;
  const int err = raise_smem_limit(fused_block_kernel<BM>, smem, &smem_configured);
  if (err) return err;
  const long long blocks = (rows + BM - 1) / BM;
  fused_block_kernel<BM><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      p, x, out, rows, h, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K5. x and out [n, h, w, c] bf16 NHWC; c a multiple of 32, at most 768
// (the caller checks).
int gcv_fused_block(const void* x, const void* wdw, const void* bdw, const void* lns,
                    const void* lnb, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* gamma, void* out, int n, int h, int w,
                    int c, void* stream) {
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
    case 64: return launch_block<64>(p, xs, o, rows, h, w, c, s);
    case 32: return launch_block<32>(p, xs, o, rows, h, w, c, s);
    default: return launch_block<16>(p, xs, o, rows, h, w, c, s);
  }
}

}  // extern "C"
