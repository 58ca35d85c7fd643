// Hand-written Hopper (sm_90a) kernel for a chain of ConvNeXt blocks (a
// stage), with a plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/convnext_stage.py). No PyTorch headers.
//
// K6  gcv_fused_stage  replaces the Pallas kernel _stage_kernel of
//     genconvit_tpu/ops/pallas/convnext_stage.py (entry fused_convnext_stage):
//     K5's block (block_wgmma.cuh) applied to every block of the chain, the
//     bf16 output of block b the input of block b+1, with the gelu_f32 form
//     of the hp GELU (zc * P * (1 / Q), exact reciprocal; the TPU's
//     approximate reciprocal and Newton step are not carried over).
//     What bounds it on the card: the matmuls, 16*R*C^2 bf16 operations a
//     block, far above the bytes, which by the published peaks are one read
//     and one write of the activation for the whole chain. In practice what
//     holds K1 (the weights streamed from L2 per row tile: at 7^2 and 14^2
//     images the tiles are few and partly empty) and the parallelism of
//     whole images.
//     What the design does: the TPU kernel keeps an image slab in VMEM
//     across the chain. A 14x14x384 image with its halo is 307 KB in bf16,
//     above the 227 KB a thread block may use, so here a work item is a
//     group of whole images (k6_images: the fewest rounds of items over the
//     SMs, then the fullest tiles) and the running activation alternates
//     between the output and one workspace, device buffers (the wrapper
//     allocates them) mostly resident in the 50 MB L2. The item walks every
//     block of the chain inside one launch on K1's warpgroup-MMA loop: per
//     block, its row tiles (taps, LayerNorm, fc1 -> GELU -> fc2, residual),
//     then a named barrier of the two consumer warpgroups before the next
//     block's taps read them. The dependency is local to the image, so no
//     grid-wide synchronization is needed; the zero halo is the conv
//     padding, as on the TPU. Block b writes out when (nb - 1 - b) is even,
//     the workspace otherwise, and block 0 reads x, which is never written.
//     The weights come through 3-D tensor maps over the stacked packs, block
//     index outermost. The VMEM-budget split of a chain (_stage_chain_chunks)
//     is TPU layout: one launch per chain here. C up to 1536 (K1's plans).
//
// The entry point returns cudaGetLastError() after its launch.

#include "block_wgmma.cuh"

extern "C" {

// K6's plan at width c for n images of hw pixels on sms SMs: out = K5's
// five values (gcv_k5_plan), then the images per work item; returns 0 where
// K6 does not take c.
int gcv_k6_plan(int c, int n, long long hw, int sms, int* out) {
  block_plan_out(c, out);
  out[5] = out[0] && n > 0 && hw > 0 ? k6_images(n, hw, out[0], sms) : 0;
  return out[0] != 0;
}

// K6. x, out (and ws when nb > 1) [n, h, w, c] bf16 NHWC; the weights are
// the nb blocks' stacked on a leading axis (w1t [nb, 4c, c], w2t [nb, c,
// 4c]: fc1.weight, fc2.weight); c one gcv_k6_plan takes (the caller checks).
int gcv_fused_stage(const void* x, const void* wdw, const void* bdw, const void* lns,
                    const void* lnb, const void* w1t, const void* b1, const void* w2t,
                    const void* b2, const void* gamma, void* ws, void* out, int n, int h,
                    int w, int c, int nb, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || nb <= 0) return static_cast<int>(cudaGetLastError());
  const MlpPlan p = mlp_wgmma_plan(c);
  if (p.rows == 0 || (nb > 1 && ws == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const long long hw = static_cast<long long>(h) * w;
  BlockArgs a;
  a.x = static_cast<const bf16*>(x);
  a.ws = static_cast<bf16*>(ws);
  a.out = static_cast<bf16*>(out);
  a.wdw = static_cast<const bf16*>(wdw);
  a.bdw = static_cast<const float*>(bdw);
  a.lns = static_cast<const float*>(lns);
  a.lnb = static_cast<const float*>(lnb);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.gamma = static_cast<const float*>(gamma);
  a.rows = n * hw;
  a.item_rows = k6_images(n, hw, p.rows, sm_count()) * hw;
  a.h = h;
  a.w = w;
  a.c = c;
  a.nb = nb;
  a.stages = p.stages;
  return launch_block_kernel<GeluHp<1>>(a, w1t, w2t, p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
