// K4 gcv_ln_mlp_residual_int8: the ConvNeXt block tail with int8 tensor-core
// matmuls, a hand-written Hopper (sm_90a) kernel with a plain C interface
// loaded through ctypes (genconvit_tpu_torch/ops/cuda/convnext_mlp_int8.py).
//
// Replaces the Pallas kernels _mlp_kernel_int8_fc1, _mlp_kernel_post_ln_int8_fc1
// ('fc1' mode), _mlp_kernel_int8 and _mlp_kernel_post_ln_int8 ('full' mode)
// of genconvit_tpu/ops/pallas/convnext_mlp.py (entry fused_ln_mlp_residual,
// int8=mode). Per row of the depthwise-conv output d and the block input x,
// both [R, C] bf16:
//   y  = (d - mean) * rstd                      f32, not rounded; E[d^2] - mean^2
//   fc1  yq = int8(clip(rint(y * 127/8)))       fixed scale: LN rows have unit variance
//        zf = f32(yq . wq1) * s1 + bw            int32 sum; s1 carries the 8/127
//        h  = bf16(GELU(zf))
//        o  = h . w2g + b2g                      bf16 fc2, f32 sum
//   full sa = max(amax|y|, 1e-30) / 127, yq = clip(rint(y * (127 / amax)))
//        zf = f32(yq . wq1) * sa * s1 + bw
//        h  = GELU(zf)                           kept in f32
//        hq, sb = the same per-row int8 of h over the whole 4C row
//        o  = f32(hq . wq2) * sb * s2 + b2g      int32 sum
//   out = x + bf16(o), or with post-LN bf16(LN(f32(x) + o) * lns + lnb).
// GELU is the plan's rational tier (common.cuh); rounding is half to even
// (__float2int_rn); the dequantizing products and sums are rounded one by
// one (__fmul_rn, __fadd_rn), as the plain version computes them. wq1
// [4C, C] is int8 in the torch Linear layout (K-major, as wgmma reads B);
// so are fc2's weights, in a copy the folds make for the kernel: 'fc1' reads
// w2t = w2g^T [C, 4C] bf16 (8 C^2 bytes a block: 25.9 MB for
// convnext_tiny's 18 blocks, 188 MB for convnext_large's 36), 'full' wq2k
// [C, 4C] int8, wq2 with k permuted inside each 32-block (4 C^2 bytes a
// block: 12.9 MB, 94 MB), so that fc1's s32 accumulator, quantized where it
// lies, is fc2's A fragment: thread t of a quad holds hidden 32b + {2t, 2t
// + 1, 8 + 2t, 9 + 2t} and {16 + 2t, .., 25 + 2t} of a row, and a k32 A
// fragment takes k 4t..4t+3 and 16+4t..19+4t, so position p of the block
// reads hidden 16 (p / 16) + 8 ((p % 4) / 2) + 2 ((p % 16) / 4) + p % 2
// (convnext_mlp_int8.KERNEL_K_ORDER). The fc2 sum is int32, exact in any
// order, so the permuted product is the product; the permutation costs no
// instruction. s1, bw [4C], s2, b2g [C] are f32.
//
// What bounds it on the card: per row the two matmuls do 16*C^2 operations,
// half ('fc1') or all ('full') on the int8 tensor cores, whose dense peak
// (1979 TOPS) is twice the bf16 one, against 6*C bytes of rows; from
// C = 192 on the tensor cores, not HBM, bound it. In practice, as for K1
// (convnext_mlp.cu), what holds it back is moving the weights from L2 into
// shared memory once per row tile per pass, the LayerNorm prologue and the
// residual epilogue at each tile, and the GELU (about 20 f32 operations per
// hidden value, here with the dequantization and, in 'full', the
// quantization on top). Its first design (mma.sync m16n8k32 and WMMA, 16-64
// row tiles, a cp.async ring refilled under a block barrier per weight
// slice) ran 3-4x slower than K1 at the same shapes.
//
// What the design does: K1's loop (mlp_wgmma.cuh) with s8 operands: y as
// int8 in shared memory (128 k a 128-byte row, half the bytes of K1's bf16
// y, so 128-row tiles reach C = 1024), fc1 as SS s8 wgmma into s32 from TMA
// tiles of wq1 in an mbarrier ring filled by one producer thread, the two
// consumer warpgroups taking turns at the tensor cores, persistent blocks,
// fc2 in output-column groups of 96-192 with fc1 recomputed per group (a
// pass). The chunk functor dequantizes the s32 accumulator in registers,
// applies the GELU (its tier a template argument) and hands fc2 its A
// operand: bf16 pairs ('fc1', K1's fc2 on w2t) or packed s8 ('full', RS s8
// wgmma on wq2k tiles of 64-byte rows); the hidden never leaves registers.
// 'full' needs each row's max|h| over the whole 4C hidden before its fc2,
// and a tile never holds a whole hidden row, so each tile first runs a
// row-maxima pass: fc1 and the GELU of every chunk, each thread keeping a
// running max of its rows' |h| (exact in any order), reduced across the
// quad that holds a row (in cols plans each warpgroup runs the whole fc1 of
// the shared 64 rows, so no exchange is needed); the passes then recompute
// fc1 and the GELU and quantize h from its f32 value. The y scale sa of
// each row comes from the prologue's max and min of d (y is monotonic in
// d), through shared memory. The tile plan (k4_plan, mirrored in
// convnext_mlp_int8.k4_plan) picks rows, group width and w1t tiles per stage
// from the instantiated candidates, only where the ring holds a turn, by the
// L2 weight traffic and tensor work of a 128-row tile; a launch with few
// rows and no post-LN may take the mode's 64-row plan instead, its passes
// split into work items (k4_launch_plan), so that more SMs share a tile.

#include "convnext_mlp_int8.cuh"

extern "C" {

// K4's tile plan at width c in mode 1 ('fc1') or 2 ('full'): out = {rows
// per block, output columns per group, w1t tiles per fc1 stage, ring
// stages, shared-memory bytes}; returns 0 where K4 does not take c (a
// multiple of 32 in [32, 1536]).
int gcv_k4_plan(int c, int mode, int* out) {
  const K4Plan p = k4_plan(c, mode == 2);
  out[0] = p.rows;
  out[1] = p.cols;
  out[2] = p.kbs;
  out[3] = p.stages;
  out[4] = p.smem;
  return p.rows != 0;
}

// convnext_mlp_int8_full.cu
int gcv_ln_mlp_residual_int8_full(const void* d, const void* x, const void* wq1, const void* s1,
                                  const void* bw, const void* w2t, const void* wq2k,
                                  const void* s2, const void* b2g, const void* lns,
                                  const void* lnb, void* vbuf, void* out, long long rows, int c,
                                  int hp, void* stream);

// K4. mode 1 = 'fc1' (w2t used, wq2k/s2 ignored), 2 = 'full' (wq2k, s2
// used, w2t ignored). c must be one gcv_k4_plan takes (the caller checks);
// lns/lnb null selects the plain residual epilogue; vbuf [rows, c] f32 is
// needed with post-LN when the plan makes more than one pass, else may be
// null.
int gcv_ln_mlp_residual_int8(const void* d, const void* x, const void* wq1, const void* s1,
                             const void* bw, const void* w2t, const void* wq2k,
                             const void* s2, const void* b2g, const void* lns,
                             const void* lnb, void* vbuf, void* out, long long rows, int c,
                             int hp, int mode, void* stream) {
  if (mode == 2) {
    return gcv_ln_mlp_residual_int8_full(d, x, wq1, s1, bw, w2t, wq2k, s2, b2g, lns, lnb, vbuf,
                                         out, rows, c, hp, stream);
  }
  return k4_launch<false>(d, x, wq1, s1, bw, w2t, wq2k, s2, b2g, lns, lnb, vbuf, out, rows, c,
                          hp, stream);
}

}  // extern "C"
