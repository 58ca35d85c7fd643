// Hand-written Hopper (sm_90a) kernel for the row LayerNorm of the ConvNeXt
// stem, with a plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/convnext_mlp.py layer_norm_rows). No
// PyTorch headers.
//
// K2  gcv_layer_norm_rows  replaces the Pallas kernel _ln_rows_kernel of
//     genconvit_tpu/ops/pallas/convnext_mlp.py (entry layer_norm_rows): per
//     row of [rows, c] bf16, f32 moments with var = E[x^2] - mean^2
//     (_row_moments), then (x - mean) * rsqrt(var + eps) * scale + bias in
//     f32, rounded to bf16.
//     What bounds it on the card: the bytes (each row read once and written
//     once; ~8 f32 operations an element are far below the f32 rate).
//     What the design does: a few lanes per row (LPR), each holding CH
//     16-byte chunks of it in registers, so x is read once and the
//     statistics are reduced over the row's lanes by shuffles; scale and
//     bias of the lane's columns are loaded once per thread; 16-byte loads
//     and stores, the row's chunks interleaved over its lanes so that a
//     warp reads contiguous bytes; a grid-stride loop over rows with about
//     48 KB in flight per SM. Instantiated for the stem widths the repo has
//     (96: tiny, 128: base, 192: large); every other multiple of 32 takes
//     the generic instantiation (one warp per row, up to 1024 columns in
//     registers, any columns past those read a second time).
//
// The entry point returns cudaGetLastError() after its launch.

#include "wgmma.cuh"   // sm_count

namespace {

constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;
constexpr int kLnBlocksPerSm = 4;

__device__ __forceinline__ void acc_chunk(const uint4& u, float& s1, float& s2) {
  const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    s1 += f.x + f.y;
    s2 += f.x * f.x + f.y * f.y;
  }
}

__device__ __forceinline__ uint4 affine_chunk(const uint4& u, float mean, float rstd,
                                              const float* s, const float* b) {
  const bf162* h = reinterpret_cast<const bf162*>(&u);
  uint4 o;
  uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    const bf162 r = __floats2bfloat162_rn((f.x - mean) * rstd * s[2 * k] + b[2 * k],
                                          (f.y - mean) * rstd * s[2 * k + 1] + b[2 * k + 1]);
    ow[k] = *reinterpret_cast<const uint32_t*>(&r);
  }
  return o;
}

__device__ __forceinline__ void load8(const float* p, float* d) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

// LPR lanes per row, CH 16-byte chunks a lane holds; chunk j of lane q is
// the row's chunk q + LPR * j. Fixed widths: c == 8 * LPR * CH. GEN: any c
// (a multiple of 32, so c / 8 chunks is a multiple of 4), LPR = 32.
template <int LPR, int CH, bool GEN>
__global__ void __launch_bounds__(kLnThreads)
layer_norm_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, bf16* __restrict__ out, long long rows,
                       int c) {
  constexpr int kRpw = 32 / LPR;   // rows per warp
  const int lane = threadIdx.x & 31;
  const int q = lane % LPR, sub = lane / LPR;
  const unsigned gmask = LPR == 32 ? 0xffffffffu : ((1u << LPR) - 1u) << (sub * LPR);
  const int nch = GEN ? c / 8 : LPR * CH;
  const float inv_c = 1.0f / static_cast<float>(c);
  // the lane's scale and bias, once (fixed widths)
  float ws[GEN ? 1 : CH][8], wb[GEN ? 1 : CH][8];
  if constexpr (!GEN) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      load8(scale + 8 * (q + LPR * j), ws[j]);
      load8(bias + 8 * (q + LPR * j), wb[j]);
    }
  }
  const long long stride = static_cast<long long>(gridDim.x) * kLnWarps * kRpw;
  const long long first = static_cast<long long>(blockIdx.x) * kLnWarps + threadIdx.x / 32;
  for (long long r = first * kRpw + sub; r < rows; r += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * c);
    uint4 v[CH];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int ch = q + LPR * j;
      if (!GEN || ch < nch) {
        v[j] = __ldg(xr + ch);
        acc_chunk(v[j], s1, s2);
      }
    }
    if constexpr (GEN) {
      for (int ch = q + LPR * CH; ch < nch; ch += LPR) acc_chunk(__ldg(xr + ch), s1, s2);
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(gmask, s1, o);
      s2 += __shfl_xor_sync(gmask, s2, o);
    }
    const float mean = s1 * inv_c;
    const float rstd = rsqrtf(s2 * inv_c - mean * mean + kLnEps);
    uint4* orow = reinterpret_cast<uint4*>(out + r * c);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int ch = q + LPR * j;
      if constexpr (GEN) {
        if (ch < nch) {
          float s[8], b[8];
          load8(scale + 8 * ch, s);
          load8(bias + 8 * ch, b);
          orow[ch] = affine_chunk(v[j], mean, rstd, s, b);
        }
      } else {
        orow[ch] = affine_chunk(v[j], mean, rstd, ws[j], wb[j]);
      }
    }
    if constexpr (GEN) {
      for (int ch = q + LPR * CH; ch < nch; ch += LPR) {
        float s[8], b[8];
        load8(scale + 8 * ch, s);
        load8(bias + 8 * ch, b);
        orow[ch] = affine_chunk(__ldg(xr + ch), mean, rstd, s, b);
      }
    }
  }
}

template <int LPR, int CH, bool GEN>
int launch_ln(const bf16* x, const float* scale, const float* bias, bf16* out, long long rows,
              int c, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kLnWarps * (32 / LPR);
  const long long need = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long cap = static_cast<long long>(sm_count()) * kLnBlocksPerSm;
  const long long blocks = need < cap ? need : cap;
  layer_norm_rows_kernel<LPR, CH, GEN>
      <<<static_cast<unsigned int>(blocks), kLnThreads, 0, stream>>>(x, scale, bias, out, rows, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2. x, out [rows, c] bf16 (16-byte aligned), scale, bias [c] f32
// (16-byte aligned); c a multiple of 32 (the caller checks). The stem
// widths 96, 128 and 192 take their own instantiation, every other c the
// generic one.
int gcv_layer_norm_rows(const void* x, const void* scale, const void* bias, void* out,
                        long long rows, int c, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (c <= 0 || c % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 96: return launch_ln<4, 3, false>(xp, sp, bp, op, rows, c, s);
    case 128: return launch_ln<4, 4, false>(xp, sp, bp, op, rows, c, s);
    case 192: return launch_ln<8, 3, false>(xp, sp, bp, op, rows, c, s);
    default: return launch_ln<32, 4, true>(xp, sp, bp, op, rows, c, s);
  }
}

// K2's instantiation at width c: out = {lanes per row, chunks a lane holds
// in registers, generic}; returns 0 where K2 does not take c.
int gcv_k2_plan(int c, int* out) {
  if (c <= 0 || c % 32 != 0) return 0;
  out[0] = c == 96 || c == 128 ? 4 : c == 192 ? 8 : 32;
  out[1] = c == 128 ? 4 : c == 96 || c == 192 ? 3 : 4;
  out[2] = c != 96 && c != 128 && c != 192;
  return 1;
}

}  // extern "C"
