// Hand-written Hopper (sm_90a) kernels for the ConvNeXt block tail and the
// stem LayerNorm, with a plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/convnext_mlp.py). No PyTorch headers.
//
// K1  gcv_ln_mlp_residual  replaces the Pallas kernels _mlp_kernel and
//     _mlp_kernel_post_ln of genconvit_tpu/ops/pallas/convnext_mlp.py
//     (entry fused_ln_mlp_residual). Per row of the depthwise-conv output d
//     and the block input x, both [R, C] bf16:
//       y   = bf16((d - mean) * rstd)           f32 stats, E[d^2] - mean^2
//       z   = y . wg + bw                        wg = ln_scale (.) W1, f32 acc
//       h   = bf16(GELU(z))                      rational erf, plan tier
//       o   = h . w2g + b2g                      w2g = W2 (.) gamma, f32 acc
//       out = x + bf16(o)                        bf16 add
//     post-LN variant: out = bf16(LN(x + o) * lns + lnb), the next stage's
//     downsample LayerNorm fused into the last block of a stage.
//     What bounds it on the card: neither HBM nor the tensor cores, but
//     per-iteration overhead. Measured on the H100 (PERF.md) it runs at
//     37-56 TFLOP/s at the ED call's shapes, 4-6% of the bf16 peak, and
//     stage 0 (C=96) takes about 3 ms against 0.13 ms of HBM time for its
//     three row tensors: the WMMA fragment loads from shared memory, the
//     barrier per weight slice and the exposed copy latency set the pace.
//     The roofline is the target, not the state: per row the two matmuls
//     do 16*C^2 flops against 6*C bytes (d, x, out in bf16), 2.7*C flop
//     per byte, 256 at C=96, just under the H100's ~295 bf16 ridge, and
//     2048 at C=768, so a kernel without that overhead would be
//     bandwidth-bound at C=96 and compute-bound at C=768.
//     What the design does: the [rows, 4C] hidden never
//     reaches device memory. A block keeps BM rows' normalized y in shared
//     memory and walks the hidden dimension in 128-column chunks: fc1 for
//     the chunk, then bias + GELU through a per-warp 16x16 staging tile
//     into bf16 h in shared memory, then the fc2 partial into register
//     accumulators. It writes only the [BM, C] result, so device memory
//     sees exactly the three row tensors. BM (64/32/16 rows for C up to
//     192/384/768) keeps the f32 fc2 accumulator at 6 WMMA tiles per warp
//     at most; the 8 warps tile (row strips) x (column tiles). The weights
//     (L2-resident, at most 9.4 MB at C=768) stream through a ring of 3-4
//     shared-memory stages in 32-row (fc1) and 16-row (fc2) slices with
//     cp.async, several slices ahead of the tensor cores, and are shared by
//     all warps of the block. Tensor cores run through WMMA (bf16 in, f32
//     accumulate). That loop is MlpTile (mlp_tile.cuh), shared with K5 and
//     K6. Cutting the overhead named above (mma.sync/ldmatrix or
//     wgmma warp tiles, TMA, fewer barriers per flop) is later work.
//
// K2  gcv_layer_norm_rows  replaces the Pallas kernel _ln_rows_kernel
//     (entry layer_norm_rows) of the same file: a row LayerNorm with f32
//     statistics and f32 affine, bf16 in and out; on the scoring path it is
//     the stem LN (C=96). One warp per row; it is bound by HBM bandwidth
//     (one read, one write of the rows), so it reads and writes bf16 pairs.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "mlp_tile.cuh"

namespace {

struct MlpArgs {
  const bf16* d;
  const bf16* x;
  const bf16* wg;     // [C, 4C]
  const float* bw;    // [4C]
  const bf16* w2g;    // [4C, C]
  const float* b2g;   // [C]
  const float* lns;   // [C] next-stage LN scale, null without post-LN
  const float* lnb;   // [C]
  bf16* out;
  long long rows;
  int c;
  int hp;
};

// K1's GELU: the plan's rational tier with the fast reciprocal.
struct GeluTier {
  int hp;
  __device__ __forceinline__ float operator()(float h) const { return gelu_rational(h, hp); }
};

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
ln_mlp_residual_kernel(const MlpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpTile<BM> mlp(smem, a.c, a.wg, a.bw, a.w2g);
  // the first slices are in flight during the LayerNorm pass
  mlp.prefetch();
  const int c = a.c;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int half_c = c / 2;
  const float inv_c = 1.0f / static_cast<float>(c);

  // 1. LayerNorm statistics and y = bf16((d - mean) * rstd); rows past the
  //    ragged end are zero and never stored.
  for (int r = warp; r < BM; r += kWarps) {
    const long long g = row0 + r;
    bf162* yrow = reinterpret_cast<bf162*>(mlp.ys + r * mlp.ldy);
    if (g < a.rows) {
      const bf162* drow = reinterpret_cast<const bf162*>(a.d + g * c);
      float sum = 0.f, sumsq = 0.f;
      for (int j = lane; j < half_c; j += 32) {
        const float2 v = __bfloat1622float2(drow[j]);
        sum += v.x + v.y;
        sumsq += v.x * v.x + v.y * v.y;
      }
      sum = warp_sum(sum);
      sumsq = warp_sum(sumsq);
      const float mean = sum * inv_c;
      const float rstd = rsqrtf(sumsq * inv_c - mean * mean + kLnEps);
      for (int j = lane; j < half_c; j += 32) {
        const float2 v = __bfloat1622float2(drow[j]);
        yrow[j] = __floats2bfloat162_rn((v.x - mean) * rstd, (v.y - mean) * rstd);
      }
    } else {
      for (int j = lane; j < half_c; j += 32) yrow[j] = __floats2bfloat162_rn(0.f, 0.f);
    }
  }

  // 2. fc1 -> GELU -> fc2 into os
  mlp.run(GeluTier{a.hp});

  // 3. epilogue, one warp per row: residual add, or residual + LayerNorm
  for (int r = warp; r < BM; r += kWarps) {
    const long long g = row0 + r;
    if (g >= a.rows) break;
    const bf16* xrow = a.x + g * c;
    float* orow = mlp.os + r * mlp.ldo;
    bf16* out = a.out + g * c;
    if (a.lns == nullptr) {
      for (int j = lane; j < c; j += 32) {
        const float o = __bfloat162float(__float2bfloat16_rn(orow[j] + a.b2g[j]));
        out[j] = __float2bfloat16_rn(__bfloat162float(xrow[j]) + o);
      }
    } else {
      float sum = 0.f, sumsq = 0.f;
      for (int j = lane; j < c; j += 32) {
        const float v = __bfloat162float(xrow[j]) + (orow[j] + a.b2g[j]);
        orow[j] = v;
        sum += v;
        sumsq += v * v;
      }
      sum = warp_sum(sum);
      sumsq = warp_sum(sumsq);
      const float mean = sum * inv_c;
      const float rstd = rsqrtf(sumsq * inv_c - mean * mean + kLnEps);
      for (int j = lane; j < c; j += 32) {
        out[j] = __float2bfloat16_rn((orow[j] - mean) * rstd * a.lns[j] + a.lnb[j]);
      }
    }
  }
}

template <int BM>
int launch_mlp(const MlpArgs& a, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = mlp_smem(a.c, BM).total;
  const int err = raise_smem_limit(ln_mlp_residual_kernel<BM>, smem, &smem_configured);
  if (err) return err;
  const long long blocks = (a.rows + BM - 1) / BM;
  ln_mlp_residual_kernel<BM><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kThreads)
layer_norm_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, bf16* __restrict__ out,
                       long long rows, int c) {
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int half_c = c / 2;
  const float inv_c = 1.0f / static_cast<float>(c);
  const bf162* xr = reinterpret_cast<const bf162*>(x + r * c);
  float s1 = 0.f, s2 = 0.f;
  for (int j = lane; j < half_c; j += 32) {
    const float2 v = __bfloat1622float2(xr[j]);
    s1 += v.x + v.y;
    s2 += v.x * v.x + v.y * v.y;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = s1 * inv_c;
  const float rstd = rsqrtf(s2 * inv_c - mean * mean + kLnEps);
  bf162* orow = reinterpret_cast<bf162*>(out + r * c);
  for (int j = lane; j < half_c; j += 32) {
    const float2 v = __bfloat1622float2(xr[j]);
    orow[j] = __floats2bfloat162_rn((v.x - mean) * rstd * scale[2 * j] + bias[2 * j],
                                    (v.y - mean) * rstd * scale[2 * j + 1] + bias[2 * j + 1]);
  }
}

}  // namespace

extern "C" {

// Rows per block K1 uses at width c (for the caller's reports).
int gcv_mlp_row_tile(int c) { return mlp_row_tile(c); }

const char* gcv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1. c must be a multiple of 32 and at most 768 (the caller checks);
// lns/lnb null selects the plain residual epilogue.
int gcv_ln_mlp_residual(const void* d, const void* x, const void* wg, const void* bw,
                        const void* w2g, const void* b2g, const void* lns,
                        const void* lnb, void* out, long long rows, int c, int hp,
                        void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  MlpArgs a;
  a.d = static_cast<const bf16*>(d);
  a.x = static_cast<const bf16*>(x);
  a.wg = static_cast<const bf16*>(wg);
  a.bw = static_cast<const float*>(bw);
  a.w2g = static_cast<const bf16*>(w2g);
  a.b2g = static_cast<const float*>(b2g);
  a.lns = static_cast<const float*>(lns);
  a.lnb = static_cast<const float*>(lnb);
  a.out = static_cast<bf16*>(out);
  a.rows = rows;
  a.c = c;
  a.hp = hp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mlp_row_tile(c)) {
    case 64: return launch_mlp<64>(a, s);
    case 32: return launch_mlp<32>(a, s);
    default: return launch_mlp<16>(a, s);
  }
}

// K2. c must be even (the caller checks a multiple of 32).
int gcv_layer_norm_rows(const void* x, const void* scale, const void* bias, void* out,
                        long long rows, int c, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (rows + kWarps - 1) / kWarps;
  layer_norm_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<bf16*>(out), rows, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
