// K4 gcv_ln_mlp_residual_int8: the ConvNeXt block tail with int8 tensor-core
// matmuls, a hand-written Hopper (sm_90a) kernel with a plain C interface
// loaded through ctypes (genconvit_tpu_torch/ops/cuda/convnext_mlp.py).
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
// one (__fmul_rn, __fadd_rn), as the plain version computes them.
// wq1 is [4C, C] and wq2 [C, 4C], int8 in the torch Linear layout (the
// reduced dimension contiguous), so that every mma fragment is one 32-bit
// shared-memory load; s1, bw [4C], s2, b2g [C] are f32.
//
// What bounds it on the card: as K1, whose structure it keeps (the note in
// convnext_mlp.cu). Per row it moves the same 6*C bytes and does the same
// 16*C^2 operations, half of them ('fc1') or all ('full') on the int8
// tensor cores, whose dense peak (1979 TOPS) is twice the bf16 one; K1 is
// held to 4-6% of the bf16 peak by per-iteration overhead (fragment loads,
// a barrier per weight slice, exposed copy latency), and so is this.
//
// What the design does: K1's. A block keeps BM rows' y (here int8) in
// shared memory and walks the hidden in 128-column chunks; weight slices
// (32 k of wq1 for 128 hidden units; then 16 hidden rows of w2g, or 32
// hidden of wq2 for all C outputs) stream through a cp.async ring shared by
// the 8 warps; the [BM, 4C] hidden never reaches device memory. The int8
// products run on mma.sync m16n8k32 (s8 in, s32 sum), each thread applying
// the dequantization, bias and GELU to its own accumulator elements; the
// bf16 fc2 of 'fc1' mode runs on WMMA as in K1.
// 'full' needs each row's absmax over the whole 4C hidden before its fc2
// can start, and K1 never holds a whole hidden row. Of the two ways out,
// keeping the f32 hidden of BM rows in shared memory (BM * 16C bytes:
// 196 KB at C = 768 and BM = 16) does not fit beside the weight ring, so
// this kernel makes two passes over the hidden: pass 1 runs fc1 + GELU for
// the row maxima only (shared-memory atomicMax on the float bits, exact in
// any order), pass 2 recomputes fc1 + GELU through the same code, quantizes
// with those maxima and runs fc2. That costs 1.5x the tensor-core work and
// streams wq1 twice (L2-resident, at most 2.4 MB), and keeps one shared-
// memory plan for every width. The fc2 sum is int32, so it is exact and
// independent of the order of the chunks.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHidChunk = 128;    // hidden columns per chunk
constexpr int kNt2 = 12;          // fc2 accumulator n8 tiles per warp (at most)
constexpr int kLdS8 = 48;         // bytes per 32-byte row of an int8 slice (+16 pad)
constexpr int kPadS8 = 16;        // int8 shared-row padding
constexpr int kPadBf16 = 8;
constexpr int kPadF32 = 4;
constexpr int kKs2Bf16 = 16;      // hidden rows of w2g per bf16 fc2 slice
constexpr float kActClip = 127.0f / 8.0f;

struct Int8Args {
  const bf16* d;
  const bf16* x;
  const int8_t* wq1;   // [4C, C]
  const float* s1;     // [4C]
  const float* bw;     // [4C]
  const bf16* w2g;     // [4C, C]  'fc1'
  const int8_t* wq2;   // [C, 4C]  'full'
  const float* s2;     // [C]      'full'
  const float* b2g;    // [C]
  const float* lns;    // [C] next-stage LN scale, null without post-LN
  const float* lnb;
  bf16* out;
  long long rows;
  int c;
  int hp;
};

__host__ __device__ constexpr int int8_row_tile(int c) {
  return c <= 192 ? 64 : c <= 384 ? 32 : 16;
}

// Ring stages per row tile and mode, so that two blocks fit on an SM at
// every width ('full' at C = 768 double-buffers its 37 KB wq2 slices).
__host__ __device__ constexpr int int8_stages(int bm, bool full) {
  return bm == 16 ? (full ? 2 : 3) : 4;
}

// Shared memory (byte offsets): yq rows, the hidden chunk (bf16 h or int8
// hq), per-row f32 stats (y scale, |h| max), the weight ring; the f32 fc2
// result reuses the ring at the end.
struct Int8Smem {
  size_t hs, stats, ring, stage, total;
};

__host__ __device__ __forceinline__ Int8Smem int8_smem(int c, int bm, bool full) {
  Int8Smem s;
  s.hs = align128(static_cast<size_t>(bm) * (c + kPadS8));
  const size_t hrow = full ? (kHidChunk + kPadS8) : (kHidChunk + kPadBf16) * sizeof(bf16);
  s.stats = s.hs + align128(static_cast<size_t>(bm) * hrow);
  s.ring = s.stats + align128(2 * static_cast<size_t>(bm) * sizeof(float));
  const size_t w1 = static_cast<size_t>(kHidChunk) * kLdS8;
  const size_t w2 = full ? static_cast<size_t>(c) * kLdS8
                         : static_cast<size_t>(kKs2Bf16) * (c + kPadBf16) * sizeof(bf16);
  s.stage = align128(w1 > w2 ? w1 : w2);
  const size_t ring = int8_stages(bm, full) * s.stage;
  const size_t os = align128(static_cast<size_t>(bm) * (c + kPadF32) * sizeof(float));
  s.total = s.ring + (ring > os ? ring : os);
  return s;
}

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ int clip127(int v) { return v > 127 ? 127 : v < -127 ? -127 : v; }

template <int BM, bool FULL>
__global__ void __launch_bounds__(kThreads, 2)
ln_mlp_residual_int8_kernel(const Int8Args a) {
  constexpr int kWM = BM / 16;                  // warp rows (16-row strips)
  constexpr int kWN = kWarps / kWM;             // warp columns
  constexpr int kNt1 = kHidChunk / 8 / kWN;     // fc1 n8 tiles per warp per chunk
  constexpr int kS2 = FULL ? kHidChunk / 32 : kHidChunk / kKs2Bf16;  // fc2 slices per chunk
  constexpr int kStages = int8_stages(BM, FULL);
  constexpr int kMaxWt = 6;                     // bf16 fc2: 16x16 WMMA tiles per warp
  constexpr int ldh8 = kHidChunk + kPadS8;      // int8 hq row (bytes)
  constexpr int ldh16 = kHidChunk + kPadBf16;   // bf16 h row (elements)
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = a.c;
  const int hidden = 4 * c;
  const int nch = hidden / kHidChunk;
  const int s1n = c / 32;                       // fc1 slices per chunk
  const int spc = s1n + kS2;                    // slices per chunk of the main pass
  const int pass1 = FULL ? nch * s1n : 0;       // 'full': the row-maxima pass first
  const int nslices = pass1 + nch * spc;
  const int ldy = c + kPadS8;
  const int ldw2 = c + kPadBf16;
  const int ldo = c + kPadF32;
  const Int8Smem lay = int8_smem(c, BM, FULL);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp / kWN;
  const int wn = warp % kWN;
  int8_t* ys = reinterpret_cast<int8_t*>(smem);
  unsigned char* hs = smem + lay.hs;
  float* ysc = reinterpret_cast<float*>(smem + lay.stats);       // [BM] y scale sa
  int* hmax = reinterpret_cast<int*>(smem + lay.stats) + BM;      // [BM] max|h| bits
  unsigned char* ring = smem + lay.ring;
  float* os = reinterpret_cast<float*>(smem + lay.ring);

  // Slice g: 'full' pass 1 is the fc1 slices of every chunk; then per chunk
  // its fc1 slices, then its fc2 slices.
  struct Slice {
    int chunk, s;   // s < s1n: fc1 k-slice s; else fc2 slice s - s1n
    bool first;     // pass 1 ('full' row maxima)
  };
  auto slice_of = [&](int gi) {
    Slice sl;
    if (gi < pass1) {
      sl.chunk = gi / s1n;
      sl.s = gi % s1n;
      sl.first = true;
    } else {
      const int gg = gi - pass1;
      sl.chunk = gg / spc;
      sl.s = gg % spc;
      sl.first = false;
    }
    return sl;
  };
  auto load_slice = [&](int gi) {
    if (gi < nslices) {
      unsigned char* dst = ring + (gi % kStages) * lay.stage;
      const Slice sl = slice_of(gi);
      const int h0 = sl.chunk * kHidChunk;
      if (sl.s < s1n) {            // wq1[h0:h0+128, 32s:32s+32]
        const int8_t* src = a.wq1 + static_cast<size_t>(h0) * c + sl.s * 32;
        for (int i = threadIdx.x; i < kHidChunk * 2; i += kThreads) {
          const int r = i / 2, q = i % 2;
          cp_async16(dst + r * kLdS8 + q * 16, src + static_cast<size_t>(r) * c + q * 16);
        }
      } else if (FULL) {           // wq2[0:C, h0+32j : h0+32j+32]
        const int8_t* src = a.wq2 + h0 + (sl.s - s1n) * 32;
        for (int i = threadIdx.x; i < c * 2; i += kThreads) {
          const int r = i / 2, q = i % 2;
          cp_async16(dst + r * kLdS8 + q * 16, src + static_cast<size_t>(r) * hidden + q * 16);
        }
      } else {                     // w2g[h0+16j : h0+16j+16, 0:C]
        const bf16* src = a.w2g + static_cast<size_t>(h0 + (sl.s - s1n) * kKs2Bf16) * c;
        bf16* d16 = reinterpret_cast<bf16*>(dst);
        const int per_row = c / 8;
        for (int i = threadIdx.x; i < kKs2Bf16 * per_row; i += kThreads) {
          const int r = i / per_row, q = i % per_row;
          cp_async16(d16 + r * ldw2 + q * 8, src + static_cast<size_t>(r) * c + q * 8);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int gi = 0; gi < kStages - 1; ++gi) load_slice(gi);

  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const float inv_c = 1.0f / static_cast<float>(c);

  // 1. LayerNorm and the int8 of y, one warp per row; rows past the ragged
  //    end are zero and never stored.
  for (int r = warp; r < BM; r += kWarps) {
    const long long gr = row0 + r;
    int8_t* yrow = ys + r * ldy;
    if (gr >= a.rows) {
      for (int j = lane; j < c; j += 32) yrow[j] = 0;
      if (lane == 0) {
        ysc[r] = 0.0f;
        hmax[r] = 0;
      }
      continue;
    }
    const bf16* drow = a.d + gr * c;
    float sum = 0.f, sumsq = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float v = __bfloat162float(drow[j]);
      sum += v;
      sumsq += v * v;
    }
    sum = warp_sum(sum);
    sumsq = warp_sum(sumsq);
    const float mean = sum * inv_c;
    const float rstd = rsqrtf(sumsq * inv_c - mean * mean + kLnEps);
    float k = kActClip;
    if (FULL) {
      float amax = 0.f;
      for (int j = lane; j < c; j += 32) {
        amax = fmaxf(amax, fabsf((__bfloat162float(drow[j]) - mean) * rstd));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      amax = fmaxf(amax, 1e-30f);
      k = 127.0f / amax;
      if (lane == 0) {
        ysc[r] = amax * (1.0f / 127.0f);
        hmax[r] = 0;
      }
    }
    for (int j = lane; j < c; j += 32) {
      const float y = (__bfloat162float(drow[j]) - mean) * rstd;
      yrow[j] = static_cast<int8_t>(clip127(__float2int_rn(y * k)));
    }
  }

  // the bf16 fc2 accumulators ('fc1' mode, WMMA as in K1) or the int32 ones
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc16[FULL ? 1 : kMaxWt];
  int acc2[FULL ? kNt2 : 1][4];
  if (!FULL) {
#pragma unroll
    for (int j = 0; j < kMaxWt; ++j) wmma::fill_fragment(acc16[j], 0.0f);
  } else {
#pragma unroll
    for (int j = 0; j < kNt2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[j][e] = 0;
  }
  int z[kNt1][4];
  const int r_lo = wm * 16 + g;                 // this thread's accumulator rows
  const int r_hi = r_lo + 8;
  const int8_t* ya_lo = ys + r_lo * ldy + 4 * t;
  const int8_t* ya_hi = ys + r_hi * ldy + 4 * t;

  // 2. The slice stream (K1's: wait for slice gi, one barrier, refill the
  //    stage the previous slice used).
  for (int gi = 0; gi < nslices; ++gi) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_slice(gi + kStages - 1);
    const unsigned char* w = ring + (gi % kStages) * lay.stage;
    const Slice sl = slice_of(gi);
    if (sl.s < s1n) {
      // fc1: z[rows of strip wm, this warp's kNt1 n8 tiles of the chunk]
      if (sl.s == 0) {
#pragma unroll
        for (int j = 0; j < kNt1; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) z[j][e] = 0;
      }
      const int k0 = sl.s * 32;
      const uint32_t a0 = ld_s32(ya_lo + k0), a1 = ld_s32(ya_hi + k0);
      const uint32_t a2 = ld_s32(ya_lo + k0 + 16), a3 = ld_s32(ya_hi + k0 + 16);
#pragma unroll
      for (int j = 0; j < kNt1; ++j) {
        const int8_t* wb = reinterpret_cast<const int8_t*>(w) +
                           ((wn * kNt1 + j) * 8 + g) * kLdS8 + 4 * t;
        mma_s8_16832(z[j], a0, a1, a2, a3, ld_s32(wb), ld_s32(wb + 16));
      }
      if (sl.s == s1n - 1) {
        // dequantize + bias + GELU on this thread's elements: rows r_lo,
        // r_hi; chunk columns (wn*kNt1 + j)*8 + 2t + {0, 1}
        const int h0 = sl.chunk * kHidChunk;
        float lo_max = 0.f, hi_max = 0.f;
        float qinv_lo = 0.f, qinv_hi = 0.f;
        if (FULL && !sl.first) {
          const float m_lo = fmaxf(__int_as_float(hmax[r_lo]), 1e-30f);
          const float m_hi = fmaxf(__int_as_float(hmax[r_hi]), 1e-30f);
          qinv_lo = 127.0f / m_lo;
          qinv_hi = 127.0f / m_hi;
        }
#pragma unroll
        for (int j = 0; j < kNt1; ++j) {
          const int col = (wn * kNt1 + j) * 8 + 2 * t;
          float hv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hc = h0 + col + (e & 1);
            float zf = static_cast<float>(z[j][e]);
            if (FULL) zf = __fmul_rn(zf, ysc[e < 2 ? r_lo : r_hi]);
            zf = __fadd_rn(__fmul_rn(zf, a.s1[hc]), a.bw[hc]);
            hv[e] = gelu_rational(zf, a.hp);
          }
          if (!FULL) {
            bf16* h16 = reinterpret_cast<bf16*>(hs);
            *reinterpret_cast<bf162*>(h16 + r_lo * ldh16 + col) = __floats2bfloat162_rn(hv[0], hv[1]);
            *reinterpret_cast<bf162*>(h16 + r_hi * ldh16 + col) = __floats2bfloat162_rn(hv[2], hv[3]);
          } else if (sl.first) {
            lo_max = fmaxf(lo_max, fmaxf(fabsf(hv[0]), fabsf(hv[1])));
            hi_max = fmaxf(hi_max, fmaxf(fabsf(hv[2]), fabsf(hv[3])));
          } else {
            const int q0 = clip127(__float2int_rn(hv[0] * qinv_lo));
            const int q1 = clip127(__float2int_rn(hv[1] * qinv_lo));
            const int q2 = clip127(__float2int_rn(hv[2] * qinv_hi));
            const int q3 = clip127(__float2int_rn(hv[3] * qinv_hi));
            *reinterpret_cast<uint16_t*>(hs + r_lo * ldh8 + col) =
                static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
            *reinterpret_cast<uint16_t*>(hs + r_hi * ldh8 + col) =
                static_cast<uint16_t>((q2 & 0xff) | ((q3 & 0xff) << 8));
          }
        }
        if (FULL && sl.first) {
          // the row max over this quad (lanes 4g..4g+3), then over the
          // strip's warps
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            lo_max = fmaxf(lo_max, __shfl_xor_sync(0xffffffffu, lo_max, o));
            hi_max = fmaxf(hi_max, __shfl_xor_sync(0xffffffffu, hi_max, o));
          }
          if (t == 0) {
            atomicMax(hmax + r_lo, __float_as_int(lo_max));
            atomicMax(hmax + r_hi, __float_as_int(hi_max));
          }
        }
      }
    } else if (FULL) {
      // int8 fc2: acc2[strip wm, n8 tiles wn + kWN*j of C] += hq . wq2 slice
      const int k0 = (sl.s - s1n) * 32;
      const unsigned char* ha_lo = hs + r_lo * ldh8 + k0 + 4 * t;
      const unsigned char* ha_hi = hs + r_hi * ldh8 + k0 + 4 * t;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ha_lo);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ha_hi);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ha_lo + 16);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ha_hi + 16);
#pragma unroll
      for (int j = 0; j < kNt2; ++j) {
        const int nt = wn + kWN * j;
        if (nt * 8 < c) {
          const int8_t* wb = reinterpret_cast<const int8_t*>(w) + (nt * 8 + g) * kLdS8 + 4 * t;
          mma_s8_16832(acc2[j], a0, a1, a2, a3, ld_s32(wb), ld_s32(wb + 16));
        }
      }
    } else {
      // bf16 fc2 ('fc1' mode), as K1: acc16 += h . w2g slice
      const int k0 = (sl.s - s1n) * kKs2Bf16;
      const bf16* h16 = reinterpret_cast<const bf16*>(hs);
      const bf16* w16 = reinterpret_cast<const bf16*>(w);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, h16 + wm * 16 * ldh16 + k0, ldh16);
#pragma unroll
      for (int j = 0; j < kMaxWt; ++j) {
        const int nt = wn + kWN * j;
        if (nt * 16 < c) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, w16 + nt * 16, ldw2);
          wmma::mma_sync(acc16[j], fa, fb, acc16[j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes os

  if (!FULL) {
#pragma unroll
    for (int j = 0; j < kMaxWt; ++j) {
      const int nt = wn + kWN * j;
      if (nt * 16 < c) {
        wmma::store_matrix_sync(os + wm * 16 * ldo + nt * 16, acc16[j], ldo, wmma::mem_row_major);
      }
    }
  } else {
    const float sb_lo = fmaxf(__int_as_float(hmax[r_lo]), 1e-30f) * (1.0f / 127.0f);
    const float sb_hi = fmaxf(__int_as_float(hmax[r_hi]), 1e-30f) * (1.0f / 127.0f);
#pragma unroll
    for (int j = 0; j < kNt2; ++j) {
      const int nt = wn + kWN * j;
      if (nt * 8 < c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? r_lo : r_hi;
          const float sb = e < 2 ? sb_lo : sb_hi;
          os[row * ldo + col] =
              __fmul_rn(__fmul_rn(static_cast<float>(acc2[j][e]), sb), a.s2[col]);
        }
      }
    }
  }
  __syncthreads();

  // 3. epilogue, one warp per row (K1's): residual add, or residual + LN
  for (int r = warp; r < BM; r += kWarps) {
    const long long gr = row0 + r;
    if (gr >= a.rows) break;
    const bf16* xrow = a.x + gr * c;
    float* orow = os + r * ldo;
    bf16* out = a.out + gr * c;
    if (a.lns == nullptr) {
      for (int j = lane; j < c; j += 32) {
        const float o = __bfloat162float(__float2bfloat16_rn(__fadd_rn(orow[j], a.b2g[j])));
        out[j] = __float2bfloat16_rn(__bfloat162float(xrow[j]) + o);
      }
    } else {
      float sum = 0.f, sumsq = 0.f;
      for (int j = lane; j < c; j += 32) {
        const float v = __bfloat162float(xrow[j]) + __fadd_rn(orow[j], a.b2g[j]);
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

template <int BM, bool FULL>
int launch_int8(const Int8Args& a, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = int8_smem(a.c, BM, FULL).total;
  if (smem > smem_configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_mlp_residual_int8_kernel<BM, FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_configured = smem;
  }
  const long long blocks = (a.rows + BM - 1) / BM;
  ln_mlp_residual_int8_kernel<BM, FULL>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool FULL>
int launch_int8_width(const Int8Args& a, cudaStream_t s) {
  switch (int8_row_tile(a.c)) {
    case 64: return launch_int8<64, FULL>(a, s);
    case 32: return launch_int8<32, FULL>(a, s);
    default: return launch_int8<16, FULL>(a, s);
  }
}

}  // namespace

extern "C" {

// K4. mode 1 = 'fc1' (w2g used, wq2/s2 ignored), 2 = 'full' (wq2, s2 used,
// w2g ignored). c must be a multiple of 32 and at most 768 (the caller
// checks); lns/lnb null selects the plain residual epilogue.
int gcv_ln_mlp_residual_int8(const void* d, const void* x, const void* wq1, const void* s1,
                             const void* bw, const void* w2g, const void* wq2,
                             const void* s2, const void* b2g, const void* lns,
                             const void* lnb, void* out, long long rows, int c, int hp,
                             int mode, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  Int8Args a;
  a.d = static_cast<const bf16*>(d);
  a.x = static_cast<const bf16*>(x);
  a.wq1 = static_cast<const int8_t*>(wq1);
  a.s1 = static_cast<const float*>(s1);
  a.bw = static_cast<const float*>(bw);
  a.w2g = static_cast<const bf16*>(w2g);
  a.wq2 = static_cast<const int8_t*>(wq2);
  a.s2 = static_cast<const float*>(s2);
  a.b2g = static_cast<const float*>(b2g);
  a.lns = static_cast<const float*>(lns);
  a.lnb = static_cast<const float*>(lnb);
  a.out = static_cast<bf16*>(out);
  a.rows = rows;
  a.c = c;
  a.hp = hp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == 2 ? launch_int8_width<true>(a, s) : launch_int8_width<false>(a, s);
}

}  // extern "C"
