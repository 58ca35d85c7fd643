// Hand-written Hopper (sm_90a) kernel for one whole ConvNeXt block, with a
// plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/convnext_block.py). No PyTorch headers.
//
// K5  gcv_fused_block  replaces the Pallas kernel _block_kernel of
//     genconvit_tpu/ops/pallas/convnext_block.py (entry fused_convnext_block):
//     depthwise 7x7 + bias -> LayerNorm -> fc1 -> GELU (hp rational erf,
//     exact divide, whatever the plan's tier) -> fc2 -> layer scale ->
//     residual, on an NHWC bf16 activation, the math of block_wgmma.cuh.
//     What bounds it on the card: by the published peaks, the two matmuls
//     (16*R*C^2 bf16 operations) and the 49 f32 taps (98*R*C operations at
//     67 TFLOP/s), which at C=96 weigh about the same; the bytes (x in, out
//     out, 4*C bytes a row) are below both. In practice what holds K1 holds
//     it (the weights streamed from L2 per row tile, the prologue and the
//     epilogue at each tile; convnext_mlp.cu), and its taps, whose loads
//     and address arithmetic, not their flops, set their cost.
//     What the design does: the block on K1's warpgroup-MMA loop
//     (block_wgmma.cuh): each consumer warpgroup computes its rows' taps
//     and LayerNorm straight into the y tiles, so the conv output and the
//     [R, 4C] hidden never reach device memory and a block costs one read
//     and one write of the activation (cuDNN's depthwise conv + K1 move it
//     three times more). Work items are the loop's row tiles over the
//     flattened [N*H*W] rows (128 rows up to C = 384, 64 above), C up to
//     1536 as K1's. The 128-lane channel padding and the 8-aligned W
//     padding of the TPU kernel are Mosaic layout and not here.
//
// The entry point returns cudaGetLastError() after its launch.

#include "block_wgmma.cuh"

extern "C" {

// K5's plan at width c: out = {rows per tile, output columns per group,
// ring stages, shared-memory bytes, channel pairs a lane holds in the
// taps}; returns 0 where K5 does not take c (a multiple of 32 in [32,
// 1536]).
int gcv_k5_plan(int c, int* out) {
  block_plan_out(c, out);
  return out[0] != 0;
}

// K5. x and out [n, h, w, c] bf16 NHWC; w1t [4c, c] = fc1.weight, w2t
// [c, 4c] = fc2.weight; c one gcv_k5_plan takes (the caller checks).
int gcv_fused_block(const void* x, const void* wdw, const void* bdw, const void* lns,
                    const void* lnb, const void* w1t, const void* b1, const void* w2t,
                    const void* b2, const void* gamma, void* out, int n, int h, int w,
                    int c, void* stream) {
  const long long rows = static_cast<long long>(n) * h * w;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const MlpPlan p = mlp_wgmma_plan(c);
  if (p.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  BlockArgs a;
  a.x = static_cast<const bf16*>(x);
  a.ws = nullptr;
  a.out = static_cast<bf16*>(out);
  a.wdw = static_cast<const bf16*>(wdw);
  a.bdw = static_cast<const float*>(bdw);
  a.lns = static_cast<const float*>(lns);
  a.lnb = static_cast<const float*>(lnb);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.gamma = static_cast<const float*>(gamma);
  a.rows = rows;
  a.item_rows = p.rows;   // one row tile an item
  a.h = h;
  a.w = w;
  a.c = c;
  a.nb = 1;
  a.stages = p.stages;
  return launch_block_kernel<GeluHp<0>>(a, w1t, w2t, p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
