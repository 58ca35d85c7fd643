// Hand-written Hopper (sm_90a) kernel for a chain of ConvNeXt blocks (a
// stage), with a plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/convnext_stage.py). No PyTorch headers.
//
// K6  gcv_fused_stage  replaces the Pallas kernel _stage_kernel of
//     genconvit_tpu/ops/pallas/convnext_stage.py (entry fused_convnext_stage):
//     K5's block (fused_block.cuh) applied to every block of the chain, the
//     bf16 output of block b the input of block b+1, with the gelu_f32 form
//     of the hp GELU (zc * P * (1 / Q), exact reciprocal; the TPU's
//     approximate reciprocal and Newton step are not carried over).
//     What bounds it on the card: the matmuls, 16*R*C^2 bf16 operations a
//     block (C = 384 or 768 on the scoring path), far above the bytes, which
//     by the published peaks are one read and one write of the activation
//     for the whole chain. In practice K1's per-iteration overhead and the
//     parallelism: one thread block per image gives 120-240 blocks, one
//     wave on the 132 SMs, with room for two blocks on each; at 120 images
//     half of that room is idle.
//     What the design does: the TPU kernel keeps an image slab in VMEM
//     across the chain. A 14x14x384 image with its halo is 307 KB in bf16,
//     above the 227 KB a thread block may use, so here a thread block owns
//     whole images and keeps the running activation in a ping-pong pair of
//     device buffers (the output and one workspace, which the wrapper
//     allocates), mostly resident in the 50 MB L2. It walks every block of
//     the chain inside one launch: per block, the image's rows in BM-row
//     tiles (K5's tile: taps, LayerNorm, fc1 -> GELU -> fc2, residual), then
//     a barrier before the next block reads them. The dependency is local to
//     the image, so no grid-wide synchronization is needed; the zero halo is
//     the conv padding, as on the TPU. The buffers alternate so that the
//     last block writes the output: block b writes out when (nb - 1 - b) is
//     even, the workspace otherwise, and block 0 reads x, which is never
//     written. The VMEM-budget split of a chain (_stage_chain_chunks) is TPU
//     layout: one launch per chain here.
//
// The entry point returns cudaGetLastError() after its launch.

#include "fused_block.cuh"

namespace {

struct StageArgs {
  BlockWeights p;   // block 0's weights; block b's are at b times each one's size
  const bf16* x;
  bf16* ws;         // [n, h, w, c] workspace, null when nb == 1
  bf16* out;
  int h, w, c, nb;
};

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
fused_stage_kernel(const StageArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = a.c;
  const long long hw = static_cast<long long>(a.h) * a.w;
  const long long base = static_cast<long long>(blockIdx.x) * hw;
  const bf16* src = a.x;
  for (int b = 0; b < a.nb; ++b) {
    bf16* dst = (a.nb - 1 - b) % 2 == 0 ? a.out : a.ws;
    for (long long r0 = 0; r0 < hw; r0 += BM) {
      const long long end = r0 + BM < hw ? r0 + BM : hw;
      // each tile ends with a barrier: after the last, block b's output is
      // visible to every thread of this block
      fused_block_tile<BM>(smem, a.p, b, src, dst, base + r0, base + end, a.h, a.w, c,
                           GeluRecip{});
    }
    src = dst;
  }
}

template <int BM>
int launch_stage(const StageArgs& a, int n, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = mlp_smem(a.c, BM).total;
  const int err = raise_smem_limit(fused_stage_kernel<BM>, smem, &smem_configured);
  if (err) return err;
  fused_stage_kernel<BM><<<static_cast<unsigned int>(n), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6. x, out (and ws when nb > 1) [n, h, w, c] bf16 NHWC; the weights are
// the nb blocks' stacked on a leading axis; c a multiple of 32, at most 768
// (the caller checks).
int gcv_fused_stage(const void* x, const void* wdw, const void* bdw, const void* lns,
                    const void* lnb, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* gamma, void* ws, void* out, int n, int h,
                    int w, int c, int nb, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || nb <= 0) return static_cast<int>(cudaGetLastError());
  StageArgs a;
  a.p.wdw = static_cast<const bf16*>(wdw);
  a.p.bdw = static_cast<const float*>(bdw);
  a.p.lns = static_cast<const float*>(lns);
  a.p.lnb = static_cast<const float*>(lnb);
  a.p.w1 = static_cast<const bf16*>(w1);
  a.p.b1 = static_cast<const float*>(b1);
  a.p.w2 = static_cast<const bf16*>(w2);
  a.p.b2 = static_cast<const float*>(b2);
  a.p.gamma = static_cast<const float*>(gamma);
  a.x = static_cast<const bf16*>(x);
  a.ws = static_cast<bf16*>(ws);
  a.out = static_cast<bf16*>(out);
  a.h = h;
  a.w = w;
  a.c = c;
  a.nb = nb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mlp_row_tile(c)) {
    case 64: return launch_stage<64>(a, n, s);
    case 32: return launch_stage<32>(a, n, s);
    default: return launch_stage<16>(a, n, s);
  }
}

}  // extern "C"
