// M2's fc1 and gelu cuts (block_parts.cu holds the probe's note and its
// entry point, gcv_block_parts): this file instantiates them on every plan
// of K5's, so that they build beside the other cuts.

#include "block_wgmma.cuh"

extern "C" int gcv_block_parts_hidden(const void* x, const void* wdw, const void* bdw,
                                      const void* lns, const void* lnb, const void* w1t,
                                      const void* b1, const void* w2t, const void* b2,
                                      const void* gamma, void* out, int n, int h, int w, int c,
                                      int gelu, void* stream) {
  if (static_cast<long long>(n) * h * w <= 0) return static_cast<int>(cudaGetLastError());
  const MlpPlan p = mlp_wgmma_plan(c);
  if (p.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const BlockArgs a = parts_args(x, wdw, bdw, lns, lnb, b1, b2, gamma, out, n, h, w, c, p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gelu ? launch_block_kernel<GeluHp<1>, kStopGelu>(a, w1t, w2t, p, s)
              : launch_block_kernel<GeluHp<1>, kStopFc1>(a, w1t, w2t, p, s);
}
