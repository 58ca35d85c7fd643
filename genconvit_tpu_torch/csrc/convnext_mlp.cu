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
//     accumulate). Cutting the overhead named above (mma.sync/ldmatrix or
//     wgmma warp tiles, TMA, fewer barriers per flop) is later work.
//
// K2  gcv_layer_norm_rows  replaces the Pallas kernel _ln_rows_kernel
//     (entry layer_norm_rows) of the same file: a row LayerNorm with f32
//     statistics and f32 affine, bf16 in and out; on the scoring path it is
//     the stem LN (C=96). One warp per row; it is bound by HBM bandwidth
//     (one read, one write of the rows), so it reads and writes bf16 pairs.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHidChunk = 128;    // hidden columns per chunk
constexpr int kMaxNt = 6;         // fc2 accumulator 16x16 tiles per warp
constexpr int kPadBf16 = 8;       // shared-row padding (bank spread)
constexpr int kPadF32 = 4;
constexpr int kScratchLd = 16;    // per-warp 16x16 f32 staging row stride
constexpr int kKs1 = 32;          // rows of wg per fc1 weight slice
constexpr int kKs2 = 16;          // rows of w2g per fc2 weight slice

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

// Row tile per width: the f32 fc2 accumulator [BM, C] is at most 6 WMMA
// tiles per warp. BM=64 for C<=192, 32 for C<=384, 16 for C<=768; the 8
// warps form a (BM/16) x (8*16/BM) grid over (row strips, column tiles).
__host__ __device__ constexpr int mlp_row_tile(int c) {
  return c <= 192 ? 64 : c <= 384 ? 32 : 16;
}

// Weight slices stream through a ring of shared-memory stages: fc1 reads
// wg[k0:k0+32, chunk], fc2 reads w2g[chunk rows k0:k0+16, :]. Stages per
// row tile, so that two blocks fit on an SM at every width.
__host__ __device__ constexpr int mlp_stages(int bm) { return bm == 16 ? 3 : 4; }

// Shared memory of one block (byte offsets; y rows start at 0): y rows
// (bf16), the GELU'd hidden chunk (bf16), one 16x16 f32 staging tile per
// warp, and the ring of weight-slice stages, which the f32 fc2 result
// reuses at the end.
struct MlpSmem {
  size_t hs, scratch, ring, stage, total;
};

__host__ __device__ __forceinline__ MlpSmem mlp_smem(int c, int bm) {
  MlpSmem s;
  s.hs = align128(static_cast<size_t>(bm) * (c + kPadBf16) * sizeof(bf16));
  s.scratch = s.hs + align128(static_cast<size_t>(bm) * (kHidChunk + kPadBf16) * sizeof(bf16));
  s.ring = s.scratch + align128(static_cast<size_t>(kWarps) * 16 * kScratchLd * sizeof(float));
  const size_t w1 = static_cast<size_t>(kKs1) * (kHidChunk + kPadBf16) * sizeof(bf16);
  const size_t w2 = static_cast<size_t>(kKs2) * (c + kPadBf16) * sizeof(bf16);
  s.stage = align128(w1 > w2 ? w1 : w2);
  const size_t ring = mlp_stages(bm) * s.stage;
  const size_t os = align128(static_cast<size_t>(bm) * (c + kPadF32) * sizeof(float));
  s.total = s.ring + (ring > os ? ring : os);
  return s;
}

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
ln_mlp_residual_kernel(const MlpArgs a) {
  constexpr int kWM = BM / 16;                  // warp rows (16-row strips)
  constexpr int kWN = kWarps / kWM;             // warp columns
  constexpr int kNj1 = kHidChunk / 16 / kWN;    // fc1 tiles per warp per chunk
  constexpr int kS2 = kHidChunk / kKs2;         // fc2 slices per chunk
  constexpr int kStages = mlp_stages(BM);
  constexpr int ldw1 = kHidChunk + kPadBf16;
  constexpr int ldh = kHidChunk + kPadBf16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = a.c;
  const int hidden = 4 * c;
  const int s1 = c / kKs1;                      // fc1 slices per chunk
  const int spc = s1 + kS2;
  const int nslices = (hidden / kHidChunk) * spc;
  const int ldy = c + kPadBf16;
  const int ldw2 = c + kPadBf16;
  const int ldo = c + kPadF32;
  const int ctiles = c / 16;
  const MlpSmem lay = mlp_smem(c, BM);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / kWN;
  const int wn = warp % kWN;
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + lay.hs);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch) + warp * 16 * kScratchLd;
  bf16* ring = reinterpret_cast<bf16*>(smem + lay.ring);
  float* os = reinterpret_cast<float*>(smem + lay.ring);
  const size_t stage_elems = lay.stage / sizeof(bf16);

  // Issue the copies of weight slice g (chunk g / spc; its fc1 slices
  // first, then its fc2 slices) into ring stage g % kStages, 16 bytes per
  // cp.async, as one copy group (empty past the last slice, which keeps
  // the group count per loop step fixed).
  auto load_slice = [&](int g) {
    if (g < nslices) {
      bf16* dst = ring + (g % kStages) * stage_elems;
      const int h0 = (g / spc) * kHidChunk;
      const int s = g % spc;
      if (s < s1) {
        const bf16* src = a.wg + static_cast<size_t>(s * kKs1) * hidden + h0;
        constexpr int kPerRow = kHidChunk / 8;
        for (int i = threadIdx.x; i < kKs1 * kPerRow; i += kThreads) {
          const int r = i / kPerRow;
          const int q = i % kPerRow;
          cp_async16(dst + r * ldw1 + q * 8, src + static_cast<size_t>(r) * hidden + q * 8);
        }
      } else {
        const bf16* src = a.w2g + static_cast<size_t>(h0 + (s - s1) * kKs2) * c;
        const int per_row = c / 8;
        for (int i = threadIdx.x; i < kKs2 * per_row; i += kThreads) {
          const int r = i / per_row;
          const int q = i % per_row;
          cp_async16(dst + r * ldw2 + q * 8, src + static_cast<size_t>(r) * c + q * 8);
        }
      }
    }
    cp_async_commit();
  };
  // the first kStages-1 slices are in flight during the LayerNorm pass
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) load_slice(g);

  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int half_c = c / 2;
  const float inv_c = 1.0f / static_cast<float>(c);

  // 1. LayerNorm statistics and y = bf16((d - mean) * rstd); rows past the
  //    ragged end are zero and never stored.
  for (int r = warp; r < BM; r += kWarps) {
    const long long g = row0 + r;
    bf162* yrow = reinterpret_cast<bf162*>(ys + r * ldy);
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

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxNt];
#pragma unroll
  for (int j = 0; j < kMaxNt; ++j) wmma::fill_fragment(acc[j], 0.0f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> z[kNj1];

  // 2. The slice stream. Each step waits for slice g, then a barrier makes
  //    it (and the y / h writes before it) visible and guarantees every
  //    warp is done with slice g-1, whose stage slice g+kStages-1 then
  //    overwrites while slice g is computed.
  for (int g = 0; g < nslices; ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_slice(g + kStages - 1);
    const bf16* w = ring + (g % kStages) * stage_elems;
    const int s = g % spc;
    if (s < s1) {
      // fc1: z[strip wm, this warp's chunk columns] += y . wg slice
      if (s == 0) {
#pragma unroll
        for (int j = 0; j < kNj1; ++j) wmma::fill_fragment(z[j], 0.0f);
      }
#pragma unroll
      for (int kk = 0; kk < kKs1; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, ys + wm * 16 * ldy + s * kKs1 + kk, ldy);
#pragma unroll
        for (int j = 0; j < kNj1; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, w + kk * ldw1 + (wn + kWN * j) * 16, ldw1);
          wmma::mma_sync(z[j], fa, fb, z[j]);
        }
      }
      if (s == s1 - 1) {
        // bias + GELU through the warp's staging tile into hs as bf16: the
        // chunk of h lives only here
        const int h0 = (g / spc) * kHidChunk;
#pragma unroll
        for (int j = 0; j < kNj1; ++j) {
          const int nt = wn + kWN * j;
          wmma::store_matrix_sync(scratch, z[j], kScratchLd, wmma::mem_row_major);
          __syncwarp();
          const float* bias = a.bw + h0 + nt * 16;
          bf16* hrow = hs + wm * 16 * ldh + nt * 16;
#pragma unroll
          for (int e = lane; e < 256; e += 32) {
            const int r = e / 16;
            const int col = e % 16;
            hrow[r * ldh + col] = __float2bfloat16_rn(
                gelu_rational(scratch[r * kScratchLd + col] + bias[col], a.hp));
          }
          __syncwarp();
        }
      }
    } else {
      // fc2: acc[strip wm, this warp's output columns] += h . w2g slice
      const int k0 = (s - s1) * kKs2;
#pragma unroll
      for (int kk = 0; kk < kKs2; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, hs + wm * 16 * ldh + k0 + kk, ldh);
#pragma unroll
        for (int j = 0; j < kMaxNt; ++j) {
          const int nt = wn + kWN * j;
          if (nt < ctiles) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, w + kk * ldw2 + nt * 16, ldw2);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes os

#pragma unroll
  for (int j = 0; j < kMaxNt; ++j) {
    const int nt = wn + kWN * j;
    if (nt < ctiles) {
      wmma::store_matrix_sync(os + wm * 16 * ldo + nt * 16, acc[j], ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // 3. epilogue, one warp per row: residual add, or residual + LayerNorm
  for (int r = warp; r < BM; r += kWarps) {
    const long long g = row0 + r;
    if (g >= a.rows) break;
    const bf16* xrow = a.x + g * c;
    float* orow = os + r * ldo;
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
  if (smem > smem_configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_mlp_residual_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_configured = smem;
  }
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
