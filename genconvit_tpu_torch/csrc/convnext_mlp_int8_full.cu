// K4 in 'full' mode (convnext_mlp_int8.cu holds its note and its entry
// point, gcv_ln_mlp_residual_int8): this file instantiates the 'full'
// kernels, so that they build beside the 'fc1' ones.

#include "convnext_mlp_int8.cuh"

extern "C" int gcv_ln_mlp_residual_int8_full(const void* d, const void* x, const void* wq1,
                                             const void* s1, const void* bw, const void* w2t,
                                             const void* wq2k, const void* s2, const void* b2g,
                                             const void* lns, const void* lnb, void* vbuf,
                                             void* out, long long rows, int c, int hp,
                                             void* stream) {
  return k4_launch<true>(d, x, wq1, s1, bw, w2t, wq2k, s2, b2g, lns, lnb, vbuf, out, rows, c, hp,
                         stream);
}
