// A whole ConvNeXt block on the warpgroup-MMA loop of mlp_wgmma.cuh, the
// kernel of K5 (convnext_block.cu, one block) and K6 (convnext_stage.cu, a
// chain of blocks). Rows are pixels of an NHWC activation [N, H, W, C] in
// storage order; per row, as the plain versions compute it
// (ops/cuda/convnext_block.block_plain):
//
//   acc = b_dw + sum over (dy, dx) of x[y+dy-3, x+dx-3] * w_dw[dy, dx]   f32, zero halo
//   y   = bf16(((acc - mean) * rstd) * ln_scale + ln_bias)               E[acc^2] - mean^2
//   h   = bf16(GELU(y . w1 + b1))                                        hp rational, exact divide
//   out = bf16(x + ((h . w2 + b2) * gamma))                              one rounding
//
// The loop's two consumer warpgroups and its producer are K1's (MlpWgmma:
// the weights by TMA into the mbarrier ring, fc1 and fc2 on wgmma with the
// GELU'd hidden as fc2's register operand, the warpgroups taking turns at
// the tensor cores, 128-row "rows" plans up to C = 384 and 64-row "cols"
// plans above, mlp_wgmma_plan). What is the block's own:
//
// - The prologue (taps_rows_to_y) computes the depthwise taps of its rows
//   straight from x in device memory into f32 registers, then the LayerNorm
//   and its affine, and writes y in bf16 into the loop's swizzled y tiles as
//   K1's prologue does; the conv output never reaches device memory. A warp
//   takes its rows 8 at a time (a run). A run is split where an image row
//   ends; each segment slides a window along its image row: per dy, 7
//   weights and the segment's len + 6 pixels are loaded once and feed
//   7 * len fused multiply-adds (a bf16 x bf16 product is exact in f32, so
//   each rounds as the plain version's product and sum). Window slots are
//   indexed by the run's position, so every register index is a constant
//   and a row outside the segment is a predicate. How a lane holds the
//   channels depends on the width (one instantiation per range, P pairs a
//   lane): up to C = 128 four channels (one 8-byte load), with the next
//   image row fetched during this row's products and a segment whose window
//   lies inside its image row loaded without per-slot tests; up to C = 192
//   three channel pairs, fetched one row ahead; from C = 224 on, whose
//   pairs no longer fit in registers beside the loop's, the taps run twice,
//   a pair column at a time: first for the row sums, then for y.
// - The chunk functor adds b1 and applies the kernel's GELU (BlockChunk;
//   GeluHp: the hp rational erf with the correctly rounded divide, its
//   polynomials on fused multiply-adds).
// - The epilogue on the fc2 accumulator in registers rounds once:
//   bf16(x + (o + b2) * gamma).
// - The schedule: a work item is a range of rows, run for each block of the
//   chain in turn (block_consumer; the producer streams the same order with
//   produce_pass). K5's items are single row tiles; K6's are groups of whole
//   images (k6_images), since the chain's dependency is local to an image:
//   after a block's last tile the 256 consumer threads meet at a named
//   barrier before the next block's taps read its output. The running
//   activation alternates between the output and a workspace so that the
//   last block writes the output, and x is never written; every read of
//   the activation is a plain load (K6 reads what the same thread block
//   wrote earlier in the launch; for K5's, read-only loads measured no
//   faster), and each item asks L2 for the next item's rows of x while its
//   passes run.
//   The weights come through 3-D tensor maps, block index outermost, so the
//   zero fill past C holds per block.
// - The cut (Stop, a template argument of the consumer and the producer;
//   the whole block by default, which K5 and K6 instantiate): the probe M2
//   (block_parts.cu, block_parts_kernel) runs K5's schedule with K6's GELU
//   and stops after one phase, writing that phase's [rows, C] bf16 to the
//   output: x copied (dma), the taps' f32 sums rounded (dw) or the taps
//   summed in bf16 (dw_bf16acc), the LayerNorm's y (ln), the first C columns
//   of the hidden before or after the GELU (fc1, gelu; the whole 4C
//   computed, no fc2 weights streamed), or the block's output (full).
#pragma once

#include <type_traits>

#include "mlp_wgmma.cuh"

namespace {

struct BlockArgs {
  const bf16* x;        // [rows, C]: the block input (NHWC storage)
  bf16* ws;             // [rows, C] workspace, K6 with nb > 1 only
  bf16* out;            // [rows, C]
  const bf16* wdw;      // [nb, 49, C]: wdw[(dy * 7 + dx) * C + c] = conv_dw.weight[c, 0, dy, dx]
  const float* bdw;     // [nb, C]
  const float* lns;     // [nb, C]
  const float* lnb;     // [nb, C]
  const float* b1;      // [nb, 4C]
  const float* b2;      // [nb, C]
  const float* gamma;   // [nb, C]
  long long rows;       // N * H * W
  long long item_rows;  // rows per work item: a row tile (K5), whole images (K6)
  int h, w, c, nb, stages;
};

// Where a block stops: M2's phases (block_parts.PHASES, in this order);
// K5 and K6 run the whole block (kStopFull).
enum BlockStop : int { kStopDma, kStopDw, kStopDwBf16, kStopLn, kStopFc1, kStopGelu, kStopFull };

// Channel pairs a lane holds in the taps (P >= C / 64), one instantiation
// per range of widths, and the rows a warp's taps run at once.
__host__ __device__ constexpr int block_pairs(int c) {
  return c <= 128 ? 2 : c <= 192 ? 3 : c <= 384 ? 6 : c <= 768 ? 12 : 24;
}
constexpr int kTapRows = 8;

// K6's images per work item: the fewest rounds of items over the SMs times
// the row tiles of an item (a round's length), and of equal costs the most
// images, whose row tiles are fuller and stream the weights fewer times.
__host__ inline int k6_images(int n, long long hw, int tile_rows, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= n; ++g) {
    const long long items = (n + g - 1) / g;
    const long long tiles = (g * hw + tile_rows - 1) / tile_rows;
    const long long cost = (items + sms - 1) / sms * tiles;
    if (best_cost < 0 || cost <= best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

// K5's GELU (the erf form, zc * (P / Q): RECIP 0) and K6's (gelu_f32, zc *
// P * (1 / Q): RECIP 1; also the probe M2's), the hp coefficients with the
// correctly rounded divide or reciprocal. The polynomials run on fused
// multiply-adds, which round once where the plain version's product and
// sum round twice: a few f32 ulps of e, below the bf16 rounding of h
// except where h lies next to a rounding boundary (M2's 'gelu' cut writes
// h itself and shows such a flip as one ulp).
template <int RECIP>
struct GeluHp {
  __device__ __forceinline__ float operator()(float h) const {
    const float zmax = 3.625f;
    const float z = h * 0.7071067811865476f;
    const float zc = fminf(fmaxf(z, -zmax), zmax);
    const float t = zc * zc;
    float p = fmaf(-1.0666330908322879e-06f, t, 0.00015586043306483894f);
    p = fmaf(p, t, 0.0057354856364086396f);
    p = fmaf(p, t, 0.057255831726436376f);
    p = fmaf(p, t, 0.2571863689937213f);
    p = fmaf(p, t, 1.1283791233432234f);
    float q = fmaf(0.0013449923247288303f, t, 0.018689943146010534f);
    q = fmaf(q, t, 0.13783698081066592f);
    q = fmaf(q, t, 0.5612572789010719f);
    q = fmaf(q, t, 1.0f);
    float e = RECIP ? zc * p * __frcp_rn(q) : zc * __fdiv_rn(p, q);
    if (fabsf(z) >= zmax) e = copysignf(1.0f, z);
    return 0.5f * h * (1.0f + e);
  }
};

// M2's fc1 cut: the hidden before the GELU.
struct ActNone {
  __device__ __forceinline__ float operator()(float h) const { return h; }
};

// A weight pair, through the read-only path, as two f32.
__device__ __forceinline__ float2 ldg_pair(const bf162* p) { return __bfloat1622float2(__ldg(p)); }

// A bf16 pair's bits as two f32 (exact: a bf16 is the top half of an f32).
__device__ __forceinline__ float2 raw_to_float2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// The chunk functor (MlpWgmma::pass): b1 of chunk j loaded before its
// products are issued, then bf16(GELU(z + b1)): fc2's A fragments (the
// layout of K1Chunk, convnext_mlp.cu).
template <class Gelu>
struct BlockChunk {
  const float* b1;   // the current block's [4C]
  float2 bias[8];

  __device__ __forceinline__ void load(int j) {
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bias[i] = *reinterpret_cast<const float2*>(b1 + 64 * j + 8 * i + 2 * t);
    }
  }

  __device__ __forceinline__ void convert(const float* z, uint32_t (*hf)[4]) const {
    const Gelu act{};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bf162 ha = __floats2bfloat162_rn(act(__fadd_rn(z[4 * i], bias[i].x)),
                                             act(__fadd_rn(z[4 * i + 1], bias[i].y)));
      const bf162 hb = __floats2bfloat162_rn(act(__fadd_rn(z[4 * i + 2], bias[i].x)),
                                             act(__fadd_rn(z[4 * i + 3], bias[i].y)));
      hf[i / 2][(i % 2) * 2] = bf162_bits(ha);
      hf[i / 2][(i % 2) * 2 + 1] = bf162_bits(hb);
    }
  }
};

// Up to C = 128 (P = 2): a lane holds four channels (4 j .. 4 j + 3 for
// lane j < C / 4) of RB rows, so one 8-byte load serves four channels and
// one pass over the lanes covers the width. Image row dy's weights and
// window slots are fetched raw, one row ahead of the products; a segment
// whose window lies inside its image row (FULL: most of them) loads without
// a per-slot test.
template <int RB, bool FULL>
__device__ __forceinline__ void fetch_quads(const BlockArgs& a, const uint2* xk, const uint2* wk,
                                            int py, int dy, int s0, int s1, int cb, bool lj,
                                            uint2 (&wraw)[7], uint2 (&xraw)[RB + 6]) {
  const int yy = py + dy - 3;
  if (yy < 0 || yy >= a.h) return;   // warp-uniform: the row adds nothing
  const int q4 = a.c / 4;            // quads a pixel
  const uint2 z = make_uint2(0u, 0u);
  const uint2* xr = xk + (yy * a.w + cb) * q4;
#pragma unroll
  for (int dx = 0; dx < 7; ++dx) wraw[dx] = lj ? __ldg(wk + (dy * 7 + dx) * q4) : z;
#pragma unroll
  for (int q = 0; q < RB + 6; ++q) {
    bool ok = lj;
    if constexpr (!FULL) ok = ok && q >= s0 && q < s1 + 6 && cb + q >= 0 && cb + q < a.w;
    xraw[q] = ok ? xr[q * q4] : z;
  }
}

template <int RB, bool FULL>
__device__ __forceinline__ void taps_quads(const BlockArgs& a, const uint2* xk, const uint2* wk,
                                           int py, int s0, int s1, int cb, bool lj,
                                           float4 (&acc)[RB]) {
  uint2 wraw[7], xraw[RB + 6];
  fetch_quads<RB, FULL>(a, xk, wk, py, 0, s0, s1, cb, lj, wraw, xraw);
  for (int dy = 0; dy < 7; ++dy) {
    float4 wt[7], win[RB + 6];
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
      const float2 lo = raw_to_float2(wraw[dx].x), hi = raw_to_float2(wraw[dx].y);
      wt[dx] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
#pragma unroll
    for (int q = 0; q < RB + 6; ++q) {
      const float2 lo = raw_to_float2(xraw[q].x), hi = raw_to_float2(xraw[q].y);
      win[q] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    if (dy < 6) fetch_quads<RB, FULL>(a, xk, wk, py, dy + 1, s0, s1, cb, lj, wraw, xraw);
    const int yy = py + dy - 3;
    if (yy < 0 || yy >= a.h) continue;   // warp-uniform: the zero halo adds nothing
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (FULL || (i >= s0 && i < s1)) {
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          acc[i].x = fmaf(win[i + dx].x, wt[dx].x, acc[i].x);   // exact products
          acc[i].y = fmaf(win[i + dx].y, wt[dx].y, acc[i].y);
          acc[i].z = fmaf(win[i + dx].z, wt[dx].z, acc[i].z);
          acc[i].w = fmaf(win[i + dx].w, wt[dx].w, acc[i].w);
        }
      }
    }
  }
}

template <int RB, int Stop>
__device__ __forceinline__ void taps_rows_to_y_quads(const BlockArgs& a, const bf16* src, int blk,
                                                     unsigned char* ytiles, long long tile0,
                                                     int r0, int nrows, long long row_end,
                                                     int nkb) {
  const int c = a.c;
  const int q4 = c / 4;
  const int lane = threadIdx.x % 32;
  const bool lj = lane < q4;
  const long long hw = static_cast<long long>(a.h) * a.w;
  const float inv_c = 1.0f / static_cast<float>(c);
  const size_t vb = static_cast<size_t>(blk) * c;
  const uint2* wk = reinterpret_cast<const uint2*>(a.wdw + 49 * vb) + lane;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 b = lj ? *reinterpret_cast<const float4*>(a.bdw + vb + 4 * lane) : zero;
  for (int rb = 0; rb < nrows; rb += RB) {
    const long long g0 = tile0 + r0 + rb;   // the run's first row
    const long long left = row_end - g0;
    const int nv = left <= 0 ? 0 : left < RB ? static_cast<int>(left) : RB;
    float4 acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = b;
    long long n = 0;
    int py = 0, px = 0;
    if (nv > 0) {
      n = g0 / hw;
      const int rem = static_cast<int>(g0 - n * hw);
      py = rem / a.w;
      px = rem - py * a.w;
    }
    for (int s0 = 0; s0 < nv;) {
      const int s1 = nv < s0 + a.w - px ? nv : s0 + a.w - px;
      const int cb = px - s0 - 3;   // window slot q holds column cb + q
      const uint2* xk = reinterpret_cast<const uint2*>(src + n * hw * c) + lane;
      if (s0 == 0 && s1 == RB && cb >= 0 && cb + RB + 6 <= a.w) {
        taps_quads<RB, true>(a, xk, wk, py, s0, s1, cb, lj, acc);
      } else {
        taps_quads<RB, false>(a, xk, wk, py, s0, s1, cb, lj, acc);
      }
      s0 = s1;
      px = 0;
      if (++py == a.h) {
        py = 0;
        ++n;
      }
    }
    if constexpr (Stop == kStopDw) {   // M2: the sums rounded, no LayerNorm
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (i < nv && lj) {
          *reinterpret_cast<uint2*>(a.out + (g0 + i) * c + 4 * lane) =
              make_uint2(bf162_bits(__floats2bfloat162_rn(acc[i].x, acc[i].y)),
                         bf162_bits(__floats2bfloat162_rn(acc[i].z, acc[i].w)));
        }
      }
      continue;
    }
    const float4 sc = lj ? *reinterpret_cast<const float4*>(a.lns + vb + 4 * lane) : zero;
    const float4 bi = lj ? *reinterpret_cast<const float4*>(a.lnb + vb + 4 * lane) : zero;
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float4 v = acc[i];
      float s = 0.f, s2 = 0.f;
      if (lj) {
        s = (v.x + v.y) + (v.z + v.w);
        s2 = (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      const float mean = __fmul_rn(s, inv_c);
      const float rstd =
          rsqrtf(__fadd_rn(__fsub_rn(__fmul_rn(s2, inv_c), __fmul_rn(mean, mean)), kLnEps));
      if (lane >= nkb * 16) continue;   // nkb * 16 quads: the zero k past C too
      uint2 y = make_uint2(0u, 0u);
      if (i < nv && lj) {
        y.x = bf162_bits(__floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.x, mean), rstd), sc.x), bi.x),
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.y, mean), rstd), sc.y), bi.y)));
        y.y = bf162_bits(__floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.z, mean), rstd), sc.z), bi.z),
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.w, mean), rstd), sc.w), bi.w)));
      }
      if constexpr (Stop == kStopLn) {   // M2: y to the output, not the tiles
        if (i < nv && lj) *reinterpret_cast<uint2*>(a.out + (g0 + i) * c + 4 * lane) = y;
      } else {
        *reinterpret_cast<uint2*>(ytiles + (lane / 16) * 8192 +
                                  swz128((r0 + rb + i) % 64, (4 * lane) % 64)) = y;
      }
    }
  }
}

// C in (128, 192] (P = 3): RB rows at a time, every channel pair of them
// (lane + 32 k, k < P) in registers, so the LayerNorm needs no second pass
// over the taps; each image row's raw pairs are fetched one row ahead. (A
// FULL fast path as the quads' made this width 1.3x slower: six copies of
// the loop body, k by FULL, outgrew the instruction cache.)
template <int P, int RB, int Stop>
__device__ __forceinline__ void taps_rows_to_y_pairs(const BlockArgs& a, const bf16* src,
                                                     int blk, unsigned char* ytiles,
                                                     long long tile0, int r0, int nrows,
                                                     long long row_end, int nkb) {
  const int c = a.c;
  const int half_c = c / 2;
  const int lane = threadIdx.x % 32;
  const long long hw = static_cast<long long>(a.h) * a.w;
  const float inv_c = 1.0f / static_cast<float>(c);
  const size_t vb = static_cast<size_t>(blk) * c;
  const bf162* wdw = reinterpret_cast<const bf162*>(a.wdw + 49 * vb);
  const float* bdw = a.bdw + vb;
  const float* lns = a.lns + vb;
  const float* lnb = a.lnb + vb;
  const float2 zero = make_float2(0.f, 0.f);
  for (int rb = 0; rb < nrows; rb += RB) {
    const long long g0 = tile0 + r0 + rb;   // the run's first row
    const long long left = row_end - g0;
    const int nv = left <= 0 ? 0 : left < RB ? static_cast<int>(left) : RB;
    float2 acc[RB][P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int j = lane + 32 * k;
      const float2 b = j < half_c ? *reinterpret_cast<const float2*>(bdw + 2 * j) : zero;
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[i][k] = b;
    }
    long long n = 0;
    int py = 0, px = 0;
    if (nv > 0) {
      n = g0 / hw;
      const int rem = static_cast<int>(g0 - n * hw);
      py = rem / a.w;
      px = rem - py * a.w;
    }
    // segments [s0, s1) of the run: pixels (n, py, px ..) of one image row;
    // window slot q holds column px - s0 - 3 + q, so row i's tap dx is slot
    // i + dx
    for (int s0 = 0; s0 < nv;) {
      const int s1 = nv < s0 + a.w - px ? nv : s0 + a.w - px;
      const int cb = px - s0 - 3;
      {
        // the raw bf16 pairs of the next image row's weights and window
        // slots are fetched while this row's products run
        const int qlo = s0 > -cb ? s0 : -cb;   // window slots inside the image row
        const int qhi = s1 + 6 < a.w - cb ? s1 + 6 : a.w - cb;
        const bf162* xs = reinterpret_cast<const bf162*>(src + n * hw * c) + lane +
                          static_cast<long long>(cb) * half_c;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (32 * k >= half_c) continue;   // warp-uniform
          const bool lj = lane + 32 * k < half_c;
          const bf162* xk = xs + 32 * k;
          const bf162* wk = wdw + lane + 32 * k;
          uint32_t wraw[7], xraw[RB + 6];
          auto fetch = [&](int dy) {
            const int yy = py + dy - 3;
            const bool ok = lj && yy >= 0 && yy < a.h;
            const bf162* xr = xk + static_cast<long long>(yy) * a.w * half_c;
#pragma unroll
            for (int dx = 0; dx < 7; ++dx) {
              wraw[dx] = ok ? bf162_bits(__ldg(wk + (dy * 7 + dx) * half_c)) : 0u;
            }
#pragma unroll
            for (int q = 0; q < RB + 6; ++q) {
              xraw[q] = ok && q >= qlo && q < qhi
                            ? *reinterpret_cast<const uint32_t*>(xr + q * half_c)
                            : 0u;
            }
          };
          fetch(0);
          for (int dy = 0; dy < 7; ++dy) {
            float2 wt[7], win[RB + 6];
#pragma unroll
            for (int dx = 0; dx < 7; ++dx) wt[dx] = raw_to_float2(wraw[dx]);
#pragma unroll
            for (int q = 0; q < RB + 6; ++q) win[q] = raw_to_float2(xraw[q]);
            if (dy < 6) fetch(dy + 1);
            const int yy = py + dy - 3;
            if (yy < 0 || yy >= a.h) continue;   // warp-uniform: the zero halo adds nothing
#pragma unroll
            for (int i = 0; i < RB; ++i) {
              if (i >= s0 && i < s1) {
#pragma unroll
                for (int dx = 0; dx < 7; ++dx) {
                  acc[i][k].x = fmaf(win[i + dx].x, wt[dx].x, acc[i][k].x);   // exact products
                  acc[i][k].y = fmaf(win[i + dx].y, wt[dx].y, acc[i][k].y);
                }
              }
            }
          }
        }
      }
      s0 = s1;
      px = 0;
      if (++py == a.h) {
        py = 0;
        ++n;
      }
    }
    if constexpr (Stop == kStopDw) {   // M2: the sums rounded, no LayerNorm
#pragma unroll
      for (int i = 0; i < RB; ++i) {
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int j = lane + 32 * k;
          if (i < nv && j < half_c) {
            *reinterpret_cast<bf162*>(a.out + (g0 + i) * c + 2 * j) =
                __floats2bfloat162_rn(acc[i][k].x, acc[i][k].y);
          }
        }
      }
      continue;
    }
    // the LayerNorm of each row, its affine, y into the tiles
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (lane + 32 * k < half_c) {
          s += acc[i][k].x + acc[i][k].y;
          s2 += acc[i][k].x * acc[i][k].x + acc[i][k].y * acc[i][k].y;
        }
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      const float mean = __fmul_rn(s, inv_c);
      const float var = __fsub_rn(__fmul_rn(s2, inv_c), __fmul_rn(mean, mean));
      const float rstd = rsqrtf(__fadd_rn(var, kLnEps));
      const bool live = i < nv;
      const int r = (r0 + rb + i) % 64;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = lane + 32 * k;
        if (j >= nkb * 32) continue;
        bf162 y = __floats2bfloat162_rn(0.f, 0.f);
        if (live && j < half_c) {
          const float2 sc = *reinterpret_cast<const float2*>(lns + 2 * j);
          const float2 bi = *reinterpret_cast<const float2*>(lnb + 2 * j);
          y = __floats2bfloat162_rn(
              __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(acc[i][k].x, mean), rstd), sc.x), bi.x),
              __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(acc[i][k].y, mean), rstd), sc.y), bi.y));
        }
        if constexpr (Stop == kStopLn) {   // M2: y to the output, not the tiles
          if (live && j < half_c) *reinterpret_cast<bf162*>(a.out + (g0 + i) * c + 2 * j) = y;
        } else {
          *reinterpret_cast<bf162*>(ytiles + (j / 32) * 8192 + swz128(r, (2 * j) % 64)) = y;
        }
      }
    }
  }
}


// The taps of RB consecutive rows from g0 (nv of them before the item's
// end; the first is pixel (n, py, px)) for the channel pair lane + 32 k:
// acc = b_dw + the 49 taps in (dy, dx) order, f32.
template <int RB>
__device__ __forceinline__ void taps_pair(const BlockArgs& a, const bf16* src, const bf162* wdw,
                                          const float* bdw, int k, int nv, long long n, int py,
                                          int px, float2 (&acc)[RB]) {
  const int c = a.c;
  const int half_c = c / 2;
  const int j = threadIdx.x % 32 + 32 * k;
  const bool lj = j < half_c;
  const float2 zero = make_float2(0.f, 0.f);
  const float2 b = lj ? *reinterpret_cast<const float2*>(bdw + 2 * j) : zero;
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i] = b;
  for (int s0 = 0; s0 < nv;) {
    const int s1 = nv < s0 + a.w - px ? nv : s0 + a.w - px;
    const int cb = px - s0 - 3;
    for (int dy = 0; dy < 7; ++dy) {
      const int yy = py + dy - 3;
      if (yy < 0 || yy >= a.h) continue;   // warp-uniform: the zero halo adds nothing
      const bf162* xr = reinterpret_cast<const bf162*>(
                            src + (n * a.h + yy) * a.w * static_cast<long long>(c)) + j;
      const bf162* wr = wdw + dy * 7 * half_c + j;
      float2 wt[7], win[RB + 6];
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) wt[dx] = lj ? ldg_pair(wr + dx * half_c) : zero;
#pragma unroll
      for (int q = 0; q < RB + 6; ++q) {
        const int col = cb + q;
        win[q] = lj && q >= s0 && q < s1 + 6 && col >= 0 && col < a.w
                     ? __bfloat1622float2(xr[col * half_c])
                     : zero;
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (i >= s0 && i < s1) {
#pragma unroll
          for (int dx = 0; dx < 7; ++dx) {
            acc[i].x = fmaf(win[i + dx].x, wt[dx].x, acc[i].x);   // exact products
            acc[i].y = fmaf(win[i + dx].y, wt[dx].y, acc[i].y);
          }
        }
      }
    }
    s0 = s1;
    px = 0;
    if (++py == a.h) {
      py = 0;
      ++n;
    }
  }
}

// From C = 224 on (P >= 6) the pairs of a run no longer fit in registers
// (they spilled to local memory, whose traffic went to L2, and the taps
// took 5-15x their instructions' time): the taps run twice, one channel
// pair column at a time, first for the rows' sums and sums of squares, then
// for y. The recomputed sums are the same, in the same order; the second
// pass costs 98 f32 operations a row and channel, small beside the 16 * C
// tensor-core operations from C = 224 on.
template <int RB, int Stop>
__device__ __forceinline__ void taps_rows_to_y_twice(const BlockArgs& a, const bf16* src, int blk,
                                                     unsigned char* ytiles, long long tile0,
                                                     int r0, int nrows, long long row_end,
                                                     int nkb) {
  const int c = a.c;
  const int half_c = c / 2;
  const int lane = threadIdx.x % 32;
  const long long hw = static_cast<long long>(a.h) * a.w;
  const float inv_c = 1.0f / static_cast<float>(c);
  const size_t vb = static_cast<size_t>(blk) * c;
  const bf162* wdw = reinterpret_cast<const bf162*>(a.wdw + 49 * vb);
  const float* bdw = a.bdw + vb;
  const float* lns = a.lns + vb;
  const float* lnb = a.lnb + vb;
  for (int rb = 0; rb < nrows; rb += RB) {
    const long long g0 = tile0 + r0 + rb;   // the run's first row
    const long long left = row_end - g0;
    const int nv = left <= 0 ? 0 : left < RB ? static_cast<int>(left) : RB;
    long long n = 0;
    int py = 0, px = 0;
    if (nv > 0) {
      n = g0 / hw;
      const int rem = static_cast<int>(g0 - n * hw);
      py = rem / a.w;
      px = rem - py * a.w;
    }
    float s[RB], s2[RB], mean[RB], rstd[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) s[i] = s2[i] = 0.f;
    if constexpr (Stop == kStopDw) {   // M2: one pass, the sums rounded
#pragma unroll 1
      for (int k = 0; 32 * k < half_c; ++k) {
        const int j = lane + 32 * k;
        float2 acc[RB];
        taps_pair<RB>(a, src, wdw, bdw, k, nv, n, py, px, acc);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          if (i < nv && j < half_c) {
            *reinterpret_cast<bf162*>(a.out + (g0 + i) * c + 2 * j) =
                __floats2bfloat162_rn(acc[i].x, acc[i].y);
          }
        }
      }
      continue;
    }
#pragma unroll 1
    for (int k = 0; 32 * k < half_c; ++k) {
      float2 acc[RB];
      taps_pair<RB>(a, src, wdw, bdw, k, nv, n, py, px, acc);
      if (lane + 32 * k < half_c) {
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          s[i] += acc[i].x + acc[i].y;
          s2[i] += acc[i].x * acc[i].x + acc[i].y * acc[i].y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float t = warp_sum(s[i]);
      const float t2 = warp_sum(s2[i]);
      mean[i] = __fmul_rn(t, inv_c);
      rstd[i] = rsqrtf(__fadd_rn(__fsub_rn(__fmul_rn(t2, inv_c), __fmul_rn(mean[i], mean[i])),
                                 kLnEps));
    }
    // nkb * 32 pairs: the zero k past C too (M2's ln: the pairs inside C)
    const int kend = Stop == kStopLn ? (half_c + 31) / 32 : nkb;
#pragma unroll 1
    for (int k = 0; k < kend; ++k) {
      const int j = lane + 32 * k;
      float2 acc[RB];
      if (32 * k < half_c) taps_pair<RB>(a, src, wdw, bdw, k, nv, n, py, px, acc);
      float2 sc = make_float2(0.f, 0.f), bi = sc;
      if (j < half_c) {
        sc = *reinterpret_cast<const float2*>(lns + 2 * j);
        bi = *reinterpret_cast<const float2*>(lnb + 2 * j);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        bf162 y = __floats2bfloat162_rn(0.f, 0.f);
        if (i < nv && j < half_c) {
          y = __floats2bfloat162_rn(
              __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(acc[i].x, mean[i]), rstd[i]), sc.x), bi.x),
              __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(acc[i].y, mean[i]), rstd[i]), sc.y), bi.y));
        }
        if constexpr (Stop == kStopLn) {   // M2: y to the output, not the tiles
          if (i < nv && j < half_c) *reinterpret_cast<bf162*>(a.out + (g0 + i) * c + 2 * j) = y;
        } else {
          *reinterpret_cast<bf162*>(ytiles + (j / 32) * 8192 +
                                    swz128((r0 + rb + i) % 64, (2 * j) % 64)) = y;
        }
      }
    }
  }
}

// A warp's rows [tile0 + r0, + nrows) of block blk: the depthwise taps from
// src, the LayerNorm and its affine, y in bf16 into the swizzled y tiles
// (row (r0 + i) % 64 of each 64-row tile set); rows at or past row_end and
// k past C are zero. P channel pairs a lane, RB rows a run. M2's dw and ln
// cuts (Stop) write the rounded sums or y to a.out instead, rows before
// row_end only.
template <int P, int RB, int Stop = kStopFull>
__device__ __forceinline__ void taps_rows_to_y(const BlockArgs& a, const bf16* src, int blk,
                                               unsigned char* ytiles, long long tile0, int r0,
                                               int nrows, long long row_end, int nkb) {
  if constexpr (P == 2) {
    taps_rows_to_y_quads<RB, Stop>(a, src, blk, ytiles, tile0, r0, nrows, row_end, nkb);
  } else if constexpr (P == 3) {
    taps_rows_to_y_pairs<P, RB, Stop>(a, src, blk, ytiles, tile0, r0, nrows, row_end, nkb);
  } else {
    taps_rows_to_y_twice<RB, Stop>(a, src, blk, ytiles, tile0, r0, nrows, row_end, nkb);
  }
}

// M2's dma cut: a warp's rows of x, a channel pair a lane as the taps read
// them, written to a.out.
__device__ __forceinline__ void copy_rows(const BlockArgs& a, long long tile0, int r0, int nrows,
                                          long long row_end) {
  const int half_c = a.c / 2;
  for (int i = 0; i < nrows; ++i) {
    const long long r = tile0 + r0 + i;
    if (r >= row_end) break;
    const bf162* xr = reinterpret_cast<const bf162*>(a.x) + r * half_c;
    bf162* orow = reinterpret_cast<bf162*>(a.out) + r * half_c;
    for (int j = threadIdx.x % 32; j < half_c; j += 32) orow[j] = xr[j];
  }
}

// M2's dw_bf16acc cut (the JAX tool's fp32dw=False): a warp's rows of the
// depthwise conv with the bias, each product and each sum rounded to bf16
// (mul.rn / add.rn, never fused), taps in (dy, dx) order, on taps_pair's
// sliding window (the halo's zero taps add nothing, as the plain version's
// zero padding adds nothing); a channel pair a lane, RB rows a run.
__device__ __forceinline__ void taps_rows_bf16acc(const BlockArgs& a, long long tile0, int r0,
                                                  int nrows, long long row_end) {
  constexpr int RB = kTapRows;
  const int c = a.c;
  const int half_c = c / 2;
  const int lane = threadIdx.x % 32;
  const long long hw = static_cast<long long>(a.h) * a.w;
  const bf162* wdw = reinterpret_cast<const bf162*>(a.wdw);
  const bf162 zero = __floats2bfloat162_rn(0.f, 0.f);
  for (int rb = 0; rb < nrows; rb += RB) {
    const long long g0 = tile0 + r0 + rb;
    const long long left = row_end - g0;
    const int nv = left <= 0 ? 0 : left < RB ? static_cast<int>(left) : RB;
    long long n0 = 0;
    int py0 = 0, px0 = 0;
    if (nv > 0) {
      n0 = g0 / hw;
      const int rem = static_cast<int>(g0 - n0 * hw);
      py0 = rem / a.w;
      px0 = rem - py0 * a.w;
    }
#pragma unroll 1
    for (int k = 0; 32 * k < half_c; ++k) {
      const int j = lane + 32 * k;
      const bool lj = j < half_c;
      bf162 acc[RB];
      const bf162 b = lj ? __floats2bfloat162_rn(a.bdw[2 * j], a.bdw[2 * j + 1]) : zero;
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[i] = b;
      long long n = n0;
      int py = py0, px = px0;
      for (int s0 = 0; s0 < nv;) {
        const int s1 = nv < s0 + a.w - px ? nv : s0 + a.w - px;
        const int cb = px - s0 - 3;
        for (int dy = 0; dy < 7; ++dy) {
          const int yy = py + dy - 3;
          if (yy < 0 || yy >= a.h) continue;
          const bf162* xr = reinterpret_cast<const bf162*>(a.x + (n * a.h + yy) * a.w * c) + j;
          bf162 wt[7], win[RB + 6];
#pragma unroll
          for (int dx = 0; dx < 7; ++dx) wt[dx] = lj ? wdw[(dy * 7 + dx) * half_c + j] : zero;
#pragma unroll
          for (int q = 0; q < RB + 6; ++q) {
            const int col = cb + q;
            win[q] = lj && q >= s0 && q < s1 + 6 && col >= 0 && col < a.w ? xr[col * half_c] : zero;
          }
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            if (i >= s0 && i < s1) {
#pragma unroll
              for (int dx = 0; dx < 7; ++dx) {
                acc[i] = bf16x2_add_rn(acc[i], bf16x2_mul_rn(win[i + dx], wt[dx]));
              }
            }
          }
        }
        s0 = s1;
        px = 0;
        if (++py == a.h) {
          py = 0;
          ++n;
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (i < nv && lj) reinterpret_cast<bf162*>(a.out + (g0 + i) * c)[j] = acc[i];
      }
    }
  }
}

// M2's cuts before the MLP (dma, dw, dw_bf16acc, ln): K5's schedule (work
// items of row tiles, a warp's rows as block_consumer's prologue takes
// them), each warp writing its rows' phase output; no weights, no y tiles.
template <bool COLS, int P, int Stop>
__device__ __forceinline__ void prologue_consumer(const BlockArgs& a) {
  const int W = threadIdx.x / 128;
  const int ww = (threadIdx.x / 32) % 4;
  const int wrows = COLS ? 8 : 16;
  const int wr0 = COLS ? 8 * (4 * W + ww) : 64 * W + 16 * ww;
  const int nitems = static_cast<int>((a.rows + a.item_rows - 1) / a.item_rows);
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const long long tile0 = static_cast<long long>(item) * a.item_rows;
    const long long r_end = tile0 + a.item_rows < a.rows ? tile0 + a.item_rows : a.rows;
    if constexpr (Stop == kStopDma) {
      copy_rows(a, tile0, wr0, wrows, r_end);
    } else if constexpr (Stop == kStopDwBf16) {
      taps_rows_bf16acc(a, tile0, wr0, wrows, r_end);
    } else {
      taps_rows_to_y<P, kTapRows, Stop>(a, a.x, 0, nullptr, tile0, wr0, wrows, r_end,
                                        (a.c + 63) / 64);
    }
    if (item + gridDim.x < nitems) {
      prefetch_rows(a.x, static_cast<long long>(item + gridDim.x) * a.item_rows + wr0, wrows,
                    a.rows, a.c);
    }
  }
}

// M2's fc1 and gelu cuts: every 64-column chunk of the tile's 4C hidden,
// fc1 from the loop's ring as the block's passes run it (in turns, or stage
// by stage where the ring is too short for a turn), then b1 (and the GELU)
// and the rounding to bf16 of the chunk functor: fc2's A fragments. Chunks
// inside C are written to a.out (in cols plans, where both warpgroups hold
// the same rows, warpgroup w the chunks j % 2 == w); every other value goes
// into a sum that only a never-taken store reads, so that none of the
// hidden's work can be dropped.
template <class Mlp, class Chunk>
__device__ __forceinline__ void hidden_pass(const BlockArgs& a, const Mlp& mlp, int w, int yw,
                                            Chunk& ch, uint32_t& q, long long ra,
                                            long long r_end, bool last, uint32_t* sink) {
  const int t = threadIdx.x % 4;
  const int n = mlp.chunks();
  uint32_t keep = 0;
  float z[32];
  uint32_t hf[4][4];
  for (int j = 0; j < n; ++j) {
    ch.load(j);
#pragma unroll
    for (int e = 0; e < 32; ++e) z[e] = 0.f;
    if constexpr (Mlp::kStream) {
      for (int f = 0; f < mlp.fc1_stages; ++f, ++q) {
        mlp.wait_full(q);
        wgmma_fence();
        const unsigned char* st = mlp.ring + (q % mlp.stages) * Mlp::kStageBytes;
#pragma unroll
        for (int r = 0; r < Mlp::kKbs; ++r) {
          const int kb = f * Mlp::kKbs + r;
          const uint64_t da = sw128_desc(mlp.y_tile(yw, kb < mlp.nkb ? kb : 0));
          const uint64_t db = sw128_desc(st + r * 8192);
#pragma unroll
          for (int s = 0; s < 4; ++s) wgmma_ss_n64(z, da + 2 * s, db + 2 * s, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(z);
        mlp.release(q, q + 1);
      }
    } else {
      mlp.turn_begin(w);
      mlp.issue_fc1(z, yw, q);
      wgmma_commit();
      mlp.turn_end(w, !(last && j == n - 1 && w == 1));   // as MlpWgmma::pass
      wgmma_wait<0>();
      fence_regs<32>(z);
      mlp.release(q, q + mlp.fc1_stages);
      q += mlp.fc1_stages;
    }
    ch.convert(z, hf);
    // hf[i / 2][(i % 2) * 2 + h]: columns 64 j + 8 i + 2 t, + 1 of row ra + 8 h
    if (64 * j < a.c && (!Mlp::kCols || j % 2 == w)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ra + 8 * h >= r_end) continue;
        uint32_t* orow = reinterpret_cast<uint32_t*>(a.out + (ra + 8 * h) * a.c + 64 * j) + t;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (64 * j + 8 * i + 2 * t < a.c) orow[4 * i] = hf[i / 2][(i % 2) * 2 + h];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) keep ^= hf[i][0] ^ hf[i][1] ^ hf[i][2] ^ hf[i][3];
    }
  }
  if (sink != nullptr) sink[threadIdx.x] = keep;
}

// Consumer warpgroup W: every work item of its thread block, for each block
// of the chain, each row tile: the prologue, the passes, the epilogue. In
// rows plans W owns rows 64 W.. of each 128-row tile; in cols plans both
// share a 64-row tile and W takes groups W, W + 2, ...
template <int P, class Gelu, class Mlp, int Stop = kStopFull>
__device__ __forceinline__ void block_consumer(const BlockArgs& a, const Mlp& mlp,
                                               uint32_t* sink = nullptr) {
  constexpr int NC = Mlp::NC;
  constexpr bool COLS = Mlp::kCols;
  constexpr int kTile = Mlp::kRows;
  constexpr int RB = kTapRows;
  const int W = threadIdx.x / 128;
  const int c = a.c;
  const int ww = (threadIdx.x / 32) % 4;   // warp in the warpgroup: rows 16 ww..
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int yw = COLS ? 0 : W;
  const int wrows = COLS ? 8 : 16;   // a warp's prologue rows
  const int wr0 = COLS ? 8 * (4 * W + ww) : 64 * W + 16 * ww;
  uint32_t q = 0;
  float o[NC / 2];
  BlockChunk<Gelu> ch{a.b1};
  const int nitems = static_cast<int>((a.rows + a.item_rows - 1) / a.item_rows);
  mlp.turn_end(W, W == 1);   // warpgroup 0 takes the first turn
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const long long r_begin = static_cast<long long>(item) * a.item_rows;
    const long long r_end = r_begin + a.item_rows < a.rows ? r_begin + a.item_rows : a.rows;
    const int tiles = static_cast<int>((r_end - r_begin + kTile - 1) / kTile);
    const bool last_item = item + gridDim.x >= nitems;
    const bf16* src = a.x;
    for (int b = 0; b < a.nb; ++b) {
      bf16* dst = (a.nb - 1 - b) % 2 == 0 ? a.out : a.ws;
      const size_t vb = static_cast<size_t>(b) * c;
      ch.b1 = a.b1 + 4 * vb;
      // block b - 1's output (this item's rows, both warpgroups') written
      // before block b's taps read it
      if (b > 0) bar_sync(6, 256);
      for (int tile = 0; tile < tiles; ++tile) {
        const long long tile0 = r_begin + static_cast<long long>(tile) * kTile;
        const long long row0 = tile0 + (COLS ? 0 : 64 * W);

        // 1. y of the tile: rows mode, each warpgroup its own 64 rows;
        //    cols mode, the shared 64 rows, after both warpgroups are done
        //    with the last tile's
        if constexpr (COLS) {
          bar_sync(2, 256);
          taps_rows_to_y<P, RB>(a, src, b, mlp.y_tile(0, 0), tile0, wr0, wrows, r_end,
                                    mlp.nkb);
          fence_proxy_async();
          bar_sync(1, 256);
        } else {
          taps_rows_to_y<P, RB>(a, src, b, mlp.y_tile(W, 0), tile0, wr0, wrows, r_end,
                                    mlp.nkb);
          fence_proxy_async();
          bar_sync(1 + W, 128);
        }
        // the next item's rows of x into L2 while the passes run
        if (!last_item) {
          prefetch_rows(a.x, static_cast<long long>(item + gridDim.x) * a.item_rows + wr0,
                        wrows, a.rows, c);
        }

        // 2. per pass: fc1 -> GELU -> fc2 (o), then the epilogue on the
        //    group's columns: o[4i + 2h + e] is column grp * NC + 8i + 2t + e
        //    of row 16 ww + g + 8h
        const long long ra = row0 + 16 * ww + g;
        if constexpr (Stop == kStopFc1 || Stop == kStopGelu) {   // M2: the hidden alone
          hidden_pass(a, mlp, W, yw, ch, q, ra, r_end, last_item && tile == tiles - 1, sink);
          continue;
        }
        const float* b2 = a.b2 + vb;
        const float* gam = a.gamma + vb;
        for (int ps = 0; ps < mlp.passes; ++ps) {
          if constexpr (Mlp::kStream) {
            mlp.pass_stream(W, yw, ch, o, q);
          } else {
            mlp.pass(W, yw, ch, o, q,
                     last_item && b == a.nb - 1 && tile == tiles - 1 && ps == mlp.passes - 1);
          }
          const int grp = COLS ? 2 * ps + W : ps;
          constexpr int kB = 4;   // column steps whose loads are issued together
#pragma unroll
          for (int i0 = 0; i0 < NC / 8; i0 += kB) {
            float2 xv[kB][2], bv[kB], gv[kB];
#pragma unroll
            for (int ii = 0; ii < kB; ++ii) {
              const int col = grp * NC + 8 * (i0 + ii) + 2 * t;
              const bool ok = col < c;
              bv[ii] = ok ? *reinterpret_cast<const float2*>(b2 + col) : make_float2(0.f, 0.f);
              gv[ii] = ok ? *reinterpret_cast<const float2*>(gam + col) : make_float2(0.f, 0.f);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const long long r = ra + 8 * h;
                const bf162* xp = reinterpret_cast<const bf162*>(src + r * c + col);
                xv[ii][h] = ok && r < r_end ? __bfloat1622float2(*xp) : make_float2(0.f, 0.f);
              }
            }
#pragma unroll
            for (int ii = 0; ii < kB; ++ii) {
              const int i = i0 + ii;
              const int col = grp * NC + 8 * i + 2 * t;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const long long r = ra + 8 * h;
                const float v0 = __fmul_rn(__fadd_rn(o[4 * i + 2 * h], bv[ii].x), gv[ii].x);
                const float v1 = __fmul_rn(__fadd_rn(o[4 * i + 2 * h + 1], bv[ii].y), gv[ii].y);
                if (col < c && r < r_end) {
                  *reinterpret_cast<bf162*>(dst + r * c + col) = __floats2bfloat162_rn(
                      __fadd_rn(xv[ii][h].x, v0), __fadd_rn(xv[ii][h].y, v1));
                }
              }
            }
          }
        }
      }
      src = dst;
    }
  }
}

// The producer thread: the weights of the consumers' order, each item's
// blocks in turn, each block's tiles, each tile's passes (M2's fc1 and gelu
// cuts: one pass of fc1 stages a tile; its earlier cuts read no weights).
template <class Mlp, int Stop = kStopFull>
__device__ __forceinline__ void block_produce(const BlockArgs& a, const Mlp& mlp,
                                              const CUtensorMap* tm1, const CUtensorMap* tm2) {
  if constexpr (Stop < kStopFc1) return;
  const int nitems = static_cast<int>((a.rows + a.item_rows - 1) / a.item_rows);
  uint32_t q = 0;
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const long long r_begin = static_cast<long long>(item) * a.item_rows;
    const long long r_end = r_begin + a.item_rows < a.rows ? r_begin + a.item_rows : a.rows;
    const int tiles = static_cast<int>((r_end - r_begin + Mlp::kRows - 1) / Mlp::kRows);
    for (int b = 0; b < a.nb; ++b) {
      for (int tile = 0; tile < tiles; ++tile) {
        if constexpr (Stop == kStopFull) {
          for (int ps = 0; ps < mlp.passes; ++ps) mlp.produce_pass(tm1, tm2, ps, b, q);
        } else {
          for (int j = 0; j < mlp.chunks(); ++j) {
            for (int f = 0; f < mlp.fc1_stages; ++f, ++q) {
              const int slot = q % mlp.stages;
              mbar_wait(&mlp.empty[slot], ((q / mlp.stages) & 1) ^ 1);
              mlp.load_fc1(tm1, slot, f, j, b);
            }
          }
        }
      }
    }
  }
}

template <int NC, bool COLS, bool STREAM, int P, class Gelu>
__global__ void __launch_bounds__(kMlpThreads, 1)
fused_wgmma_kernel(const BlockArgs a, const __grid_constant__ CUtensorMap tm1,
                   const __grid_constant__ CUtensorMap tm2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const MlpWgmma<NC, COLS, STREAM> mlp(align1024(smem_raw), a.c, a.stages, false);
  if (threadIdx.x == 0) mlp.init_barriers();
  __syncthreads();
  if (threadIdx.x / 32 >= 8) {
    // as mlp_block: the producer warpgroup gives most of its registers up
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == 256) block_produce(a, mlp, &tm1, &tm2);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    block_consumer<P, Gelu>(a, mlp);
  }
}

// M2 (block_parts.cu): K5's schedule with K6's GELU (the fc1 cut: none),
// cut after phase Stop; its entries are named apart from K5's and K6's.
// sink: null, the never-taken store of the fc1 and gelu cuts.
template <int NC, bool COLS, bool STREAM, int P, int Stop>
__global__ void __launch_bounds__(kMlpThreads, 1)
block_parts_kernel(const BlockArgs a, const __grid_constant__ CUtensorMap tm1,
                   const __grid_constant__ CUtensorMap tm2, uint32_t* sink) {
  using Mlp = MlpWgmma<NC, COLS, STREAM>;
  using Gelu = typename std::conditional<Stop == kStopFc1, ActNone, GeluHp<1>>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Mlp mlp(align1024(smem_raw), a.c, a.stages, false);
  if (threadIdx.x == 0) mlp.init_barriers();
  __syncthreads();
  if (threadIdx.x / 32 >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == 256) block_produce<Mlp, Stop>(a, mlp, &tm1, &tm2);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    if constexpr (Stop < kStopFc1) {
      prologue_consumer<COLS, P, Stop>(a);
    } else {
      block_consumer<P, Gelu, Mlp, Stop>(a, mlp, sink);
    }
  }
}

constexpr int kWholeBlock = -1;   // the launches' Stop for K5 and K6

// One launch of K5's and K6's kernel (Stop kWholeBlock) or of M2's cut
// after phase Stop, on the grid of its work items.
template <class Gelu, int NC, bool COLS, bool STREAM, int P, int Stop = kWholeBlock>
int launch_block_inst(const BlockArgs& a, const void* w1t, const void* w2t, const MlpPlan& p,
                      cudaStream_t stream) {
  if (block_pairs(a.c) > P) return static_cast<int>(cudaErrorInvalidValue);
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = static_cast<size_t>(p.smem);
  int err;
  if constexpr (Stop == kWholeBlock) {
    err = raise_smem_limit(fused_wgmma_kernel<NC, COLS, STREAM, P, Gelu>, smem, &smem_configured);
  } else {
    err = raise_smem_limit(block_parts_kernel<NC, COLS, STREAM, P, Stop>, smem, &smem_configured);
  }
  if (err) return err;
  CUtensorMap tm1, tm2;
  int e = box_map_3d(&tm1, w1t, a.c, 4 * a.c, a.nb, 64);
  if (e == 0) e = box_map_3d(&tm2, w2t, 4 * a.c, a.c, a.nb, NC);
  if (e) return e;
  const long long items = (a.rows + a.item_rows - 1) / a.item_rows;
  const unsigned int blocks = static_cast<unsigned int>(items < sm_count() ? items : sm_count());
  if constexpr (Stop == kWholeBlock) {
    fused_wgmma_kernel<NC, COLS, STREAM, P, Gelu><<<blocks, kMlpThreads, smem, stream>>>(a, tm1, tm2);
  } else {
    block_parts_kernel<NC, COLS, STREAM, P, Stop>
        <<<blocks, kMlpThreads, smem, stream>>>(a, tm1, tm2, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch at plan p (mlp_wgmma_plan(a.c)): the instantiations of every
// (rows, NC, stream, P) that some width in [32, 1536] takes.
template <class Gelu, int Stop = kWholeBlock>
int launch_block_kernel(const BlockArgs& a, const void* w1t, const void* w2t, const MlpPlan& p,
                        cudaStream_t s) {
  const int pairs = block_pairs(a.c);
  if (p.rows == 128) {
    switch (p.cols) {
      case 96:
        return pairs == 2 ? launch_block_inst<Gelu, 96, false, false, 2, Stop>(a, w1t, w2t, p, s)
                          : launch_block_inst<Gelu, 96, false, false, 6, Stop>(a, w1t, w2t, p, s);
      case 128:
        return pairs == 2 ? launch_block_inst<Gelu, 128, false, false, 2, Stop>(a, w1t, w2t, p, s)
                          : launch_block_inst<Gelu, 128, false, false, 6, Stop>(a, w1t, w2t, p, s);
      default:
        return pairs == 3 ? launch_block_inst<Gelu, 192, false, false, 3, Stop>(a, w1t, w2t, p, s)
                          : launch_block_inst<Gelu, 192, false, false, 6, Stop>(a, w1t, w2t, p, s);
    }
  }
  const bool stream = mlp_wgmma_stream(a.c, p);
  if (p.cols == 128) {
    return stream ? launch_block_inst<Gelu, 128, true, true, 24, Stop>(a, w1t, w2t, p, s)
                  : launch_block_inst<Gelu, 128, true, false, 12, Stop>(a, w1t, w2t, p, s);
  }
  if (!stream) return launch_block_inst<Gelu, 192, true, false, 12, Stop>(a, w1t, w2t, p, s);
  return pairs == 12 ? launch_block_inst<Gelu, 192, true, true, 12, Stop>(a, w1t, w2t, p, s)
                     : launch_block_inst<Gelu, 192, true, true, 24, Stop>(a, w1t, w2t, p, s);
}

// M2's cuts before the MLP (block_parts.cu) read no weights and use no
// ring: one instantiation per (rows a warp, pairs a lane) of the taps for
// dw and ln, per rows a warp alone for dma and dw_bf16acc; the launch takes
// plan p's shared memory and grid, as K5's.
template <int Stop>
int launch_prologue_cut(const BlockArgs& a, const void* w1t, const void* w2t, const MlpPlan& p,
                        cudaStream_t s) {
  using G = GeluHp<1>;
  const int pairs = block_pairs(a.c);
  if constexpr (Stop == kStopDma || Stop == kStopDwBf16) {
    return p.rows == 128 ? launch_block_inst<G, 128, false, false, 6, Stop>(a, w1t, w2t, p, s)
                         : launch_block_inst<G, 128, true, false, 24, Stop>(a, w1t, w2t, p, s);
  } else {
    if (p.rows == 128) {
      return pairs == 2   ? launch_block_inst<G, 128, false, false, 2, Stop>(a, w1t, w2t, p, s)
             : pairs == 3 ? launch_block_inst<G, 128, false, false, 3, Stop>(a, w1t, w2t, p, s)
                          : launch_block_inst<G, 128, false, false, 6, Stop>(a, w1t, w2t, p, s);
    }
    return pairs == 12 ? launch_block_inst<G, 128, true, false, 12, Stop>(a, w1t, w2t, p, s)
                       : launch_block_inst<G, 128, true, false, 24, Stop>(a, w1t, w2t, p, s);
  }
}

// M2's arguments: one block on K5's schedule (a work item is a row tile of
// plan p), the packs as K5 reads them.
inline BlockArgs parts_args(const void* x, const void* wdw, const void* bdw, const void* lns,
                            const void* lnb, const void* b1, const void* b2, const void* gamma,
                            void* out, int n, int h, int w, int c, const MlpPlan& p) {
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
  a.rows = static_cast<long long>(n) * h * w;
  a.item_rows = p.rows;
  a.h = h;
  a.w = w;
  a.c = c;
  a.nb = 1;
  a.stages = p.stages;
  return a;
}

// A block kernel's plan at width c: K1's tile plan and the taps' pairs a
// lane; {0...} where c is not a multiple of 32 in [32, 1536].
inline void block_plan_out(int c, int* out) {
  const MlpPlan p = mlp_wgmma_plan(c);
  out[0] = p.rows;
  out[1] = p.cols;
  out[2] = p.stages;
  out[3] = p.smem;
  out[4] = p.rows ? block_pairs(c) : 0;
}

}  // namespace
