// One row tile of a whole ConvNeXt block: the first design of K5 and K6,
// which the block-phase probe M2 (block_parts.cu) keeps as it was (K5 and
// K6 now run on the warpgroup-MMA loop, block_wgmma.cuh; "K5" and "K6"
// below name that first design). Rows are pixels of an NHWC activation [N, H,
// W, C] in its storage order; per row, as the Pallas kernels compute it
// (genconvit_tpu/ops/pallas/convnext_block.py:71-98):
//
//   acc = b_dw + sum over (dy, dx) of x[y+dy-3, x+dx-3] * w_dw[dy, dx]   f32, zero halo
//   y   = bf16(((acc - mean) * rstd) * ln_scale + ln_bias)               E[acc^2] - mean^2
//   h   = bf16(GELU(y . w1 + b1))                                        hp rational, exact divide
//   out = bf16(x + ((h . w2 + b2) * gamma))
//
// The depthwise taps are computed by each warp for its rows straight from
// the input in device memory (L1/L2 serve the 49-fold reuse) into f32 sums
// in shared memory, so the conv output never reaches device memory. A
// bf16 x bf16 product is exact in f32, so each fused multiply-add rounds as
// the plain version's product and sum do, and rows need not be a rectangle
// of pixels: a tile is BM consecutive rows, so
// only the last tile of the tensor (K5) or of an image (K6) is ragged.
//
// Stop (a template argument, the whole block by default) cuts the tile
// after one of its steps for the block-phase probe (block_parts.cu), which
// then writes that step's [rows, C] bf16 result to dst; the whole block
// (kStopFull) compiles to the same code as without the argument.
#pragma once

#include "mlp_tile.cuh"

namespace {

// Channel pairs per lane at row tile BM: C <= 192 / 384 / 768 for BM =
// 64 / 32 / 16 (mlp_row_tile), so C / 64 pairs at most.
__host__ __device__ constexpr int max_pairs(int bm) { return bm == 64 ? 3 : bm == 32 ? 6 : 12; }

// Where the tile stops: x copied through shared memory (dma); bf16 of the
// depthwise f32 sums (dw) or of sums kept in bf16 (dw_bf16acc: bias, every
// product and every sum rounded to bf16, no fused multiply-add); the bf16
// LayerNorm output (ln); the first C columns of bf16(y . w1 + b1) (fc1,
// with the identity as act) or of bf16(act(y . w1 + b1)) (gelu), the whole
// 4C hidden computed in both; the block output (full).
enum TileStop : int { kStopDma, kStopDw, kStopDwBf16, kStopLn, kStopFc1, kStopGelu, kStopFull };

struct BlockWeights {   // one block's, or block 0's of a stacked chain
  const bf16* wdw;     // [49, C]: wdw[(dy * 7 + dx) * C + c] = conv_dw.weight[c, 0, dy, dx]
  const float* bdw;    // [C]
  const float* lns;    // [C]
  const float* lnb;    // [C]
  const bf16* w1;      // [C, 4C] = fc1.weight^T
  const float* b1;     // [4C]
  const bf16* w2;      // [4C, C] = fc2.weight^T
  const float* b2;     // [C]
  const float* gamma;  // [C]
};

// K5's GELU (the erf form, zc * (P / Q)) and K6's (gelu_f32, zc * P * (1 / Q)).
struct GeluErfDiv {
  __device__ __forceinline__ float operator()(float h) const { return gelu_hp_exact(h, 0); }
};
struct GeluRecip {
  __device__ __forceinline__ float operator()(float h) const { return gelu_hp_exact(h, 1); }
};

// Rows [row0, row_end) (row_end - row0 <= BM) of src [.., h, w, c] -> dst,
// with the weights of block blk of a chain stacked on a leading axis (K6;
// K5 passes blk = 0). The offsets are taken where each weight is read, so
// that no block's pointers stay live in registers across the tile. src is
// read with plain loads (never the read-only path): in K6 it was written
// earlier in the same launch by this thread block. Ends with a barrier, so
// the caller may start the next tile.
template <int BM, class Act, int Stop = kStopFull>
__device__ __forceinline__ void fused_block_tile(unsigned char* smem, const BlockWeights& p,
                                                 int blk, const bf16* src, bf16* dst,
                                                 long long row0, long long row_end, int h,
                                                 int w, int c, const Act& act) {
  constexpr bool kFc2 = Stop == kStopFull;
  const size_t vb = static_cast<size_t>(blk) * c;   // a [C] vector's offset
  const MlpTile<BM, kFc2> mlp(smem, c, p.w1 + 4 * vb * c, p.b1 + 4 * vb, p.w2 + 4 * vb * c);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int half_c = c / 2;
  const float inv_c = 1.0f / static_cast<float>(c);
  const long long hw = static_cast<long long>(h) * w;
  constexpr int kMaxPairs = max_pairs(BM);

  // 1. depthwise 7x7 + bias -> os (f32 [BM, C], the ring's space, which
  //    the weight slices take only after step 2). Each warp owns kRows
  //    consecutive rows. When they are consecutive pixels of one image row
  //    (all but the warps that cross a row's end), the warp slides a window
  //    along it, one channel pair per lane at a time: per image row dy, the
  //    7 weights and the kRows + 6 pixels are loaded once and feed 7 * kRows
  //    taps, so loads and address arithmetic are not paid per tap.
  //    Otherwise each row walks its 49 taps on its own. Taps outside the
  //    image add 0 (window) or are skipped (per row); both are the zero
  //    halo exactly, and every row sums its taps in (dy, dx) order, as the
  //    plain version does. Only one pair's (or one row's) sums are live in
  //    registers at a time.
  constexpr int kRows = BM / kWarps;
  const int r0 = warp * kRows;
  const long long g0 = row0 + r0;
  float2* os2 = reinterpret_cast<float2*>(mlp.os);
  const int ldo2 = mlp.ldo / 2;
  long long n0 = 0;
  int py0 = 0, px0 = 0;
  if (g0 < row_end) {
    n0 = g0 / hw;
    const int rem = static_cast<int>(g0 - n0 * hw);
    py0 = rem / w;
    px0 = rem - py0 * w;
  }
  if constexpr (Stop == kStopDma) {
    // each warp copies its rows through ys
    for (int i = 0; i < kRows && g0 + i < row_end; ++i) {
      bf162* yrow = reinterpret_cast<bf162*>(mlp.ys + (r0 + i) * mlp.ldy);
      const bf162* xrow = reinterpret_cast<const bf162*>(src + (g0 + i) * c);
      for (int j = lane; j < half_c; j += 32) yrow[j] = xrow[j];
      __syncwarp();
      bf162* out = reinterpret_cast<bf162*>(dst + (g0 + i) * c);
      for (int j = lane; j < half_c; j += 32) out[j] = yrow[j];
    }
    __syncthreads();
    return;
  } else if constexpr (Stop == kStopDwBf16) {
    // every row walks its 49 taps in (dy, dx) order, each product and sum
    // rounded to bf16 (mul.rn / add.rn, never fused)
    for (int i = 0; i < kRows; ++i) {
      const long long g = g0 + i;
      if (g >= row_end) break;
      const long long n = g / hw;
      const int rem = static_cast<int>(g - n * hw);
      const int py = rem / w;
      const int px = rem - py * w;
      for (int j = lane; j < half_c; j += 32) {
        bf162 acc = __floats2bfloat162_rn(p.bdw[vb + 2 * j], p.bdw[vb + 2 * j + 1]);
        for (int dy = 0; dy < 7; ++dy) {
          const int yy = py + dy - 3;
          if (yy < 0 || yy >= h) continue;
          for (int dx = 0; dx < 7; ++dx) {
            const int xx = px + dx - 3;
            if (xx < 0 || xx >= w) continue;
            const bf162 v = reinterpret_cast<const bf162*>(
                src + ((n * h + yy) * w + xx) * static_cast<long long>(c))[j];
            const bf162 wt =
                reinterpret_cast<const bf162*>(p.wdw + 49 * vb + (dy * 7 + dx) * c)[j];
            acc = bf16x2_add_rn(acc, bf16x2_mul_rn(v, wt));
          }
        }
        reinterpret_cast<bf162*>(dst + g * c)[j] = acc;
      }
    }
    __syncthreads();
    return;
  } else if (g0 + kRows <= row_end && px0 + kRows <= w) {
    for (int j = lane; j < half_c; j += 32) {
      float2 acc[kRows];
      const float* bdw = p.bdw + vb;
      const float2 b = make_float2(bdw[2 * j], bdw[2 * j + 1]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = b;
      for (int dy = 0; dy < 7; ++dy) {
        const int yy = py0 + dy - 3;
        if (yy < 0 || yy >= h) continue;
        const bf162* xr = reinterpret_cast<const bf162*>(
            src + (n0 * h + yy) * static_cast<long long>(w) * c);
        const bf162* wr = reinterpret_cast<const bf162*>(p.wdw + 49 * vb + dy * 7 * c);
        float2 wt[7];
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) wt[dx] = __bfloat1622float2(wr[dx * half_c + j]);
        float2 win[kRows + 6];
#pragma unroll
        for (int q = 0; q < kRows + 6; ++q) {
          const int xx = px0 - 3 + q;
          win[q] = xx >= 0 && xx < w ? __bfloat1622float2(xr[xx * half_c + j])
                                     : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int dx = 0; dx < 7; ++dx) {
            acc[i].x = fmaf(win[i + dx].x, wt[dx].x, acc[i].x);   // exact products
            acc[i].y = fmaf(win[i + dx].y, wt[dx].y, acc[i].y);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) os2[(r0 + i) * ldo2 + j] = acc[i];
    }
  } else {
    for (int i = 0; i < kRows; ++i) {
      const long long g = g0 + i;
      if (g >= row_end) continue;
      const long long n = g / hw;
      const int rem = static_cast<int>(g - n * hw);
      const int py = rem / w;
      const int px = rem - py * w;
      float2 acc[kMaxPairs];
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        const int j = lane + 32 * k;
        if (j < half_c) acc[k] = make_float2(p.bdw[vb + 2 * j], p.bdw[vb + 2 * j + 1]);
      }
      for (int dy = 0; dy < 7; ++dy) {
        const int yy = py + dy - 3;
        if (yy < 0 || yy >= h) continue;
        for (int dx = 0; dx < 7; ++dx) {
          const int xx = px + dx - 3;
          if (xx < 0 || xx >= w) continue;
          const bf162* xp = reinterpret_cast<const bf162*>(
              src + ((n * h + yy) * w + xx) * static_cast<long long>(c));
          const bf162* wp =
              reinterpret_cast<const bf162*>(p.wdw + 49 * vb + (dy * 7 + dx) * c);
#pragma unroll
          for (int k = 0; k < kMaxPairs; ++k) {
            const int j = lane + 32 * k;
            if (j < half_c) {
              const float2 v = __bfloat1622float2(xp[j]);
              const float2 wt = __bfloat1622float2(wp[j]);
              acc[k].x = fmaf(v.x, wt.x, acc[k].x);
              acc[k].y = fmaf(v.y, wt.y, acc[k].y);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        const int j = lane + 32 * k;
        if (j < half_c) os2[(r0 + i) * ldo2 + j] = acc[k];
      }
    }
  }
  __syncwarp();
  if constexpr (Stop == kStopDw) {
    for (int i = 0; i < kRows && g0 + i < row_end; ++i) {
      const float2* arow = os2 + (r0 + i) * ldo2;
      bf162* out = reinterpret_cast<bf162*>(dst + (g0 + i) * c);
      for (int j = lane; j < half_c; j += 32) out[j] = __float22bfloat162_rn(arow[j]);
    }
    __syncthreads();
    return;
  }

  // 2. LayerNorm and its affine, os -> ys (bf16); rows past a ragged end
  //    are zero and never stored
  for (int i = 0; i < kRows; ++i) {
    bf162* yrow = reinterpret_cast<bf162*>(mlp.ys + (r0 + i) * mlp.ldy);
    if (g0 + i >= row_end) {
      for (int j = lane; j < half_c; j += 32) yrow[j] = __floats2bfloat162_rn(0.f, 0.f);
      continue;
    }
    const float2* arow = os2 + (r0 + i) * ldo2;
    const float* lns = p.lns + vb;
    const float* lnb = p.lnb + vb;
    float sum = 0.f, sumsq = 0.f;
    for (int j = lane; j < half_c; j += 32) {
      const float2 a = arow[j];
      sum += a.x + a.y;
      sumsq += a.x * a.x + a.y * a.y;
    }
    sum = warp_sum(sum);
    sumsq = warp_sum(sumsq);
    const float mean = __fmul_rn(sum, inv_c);
    const float var = __fsub_rn(__fmul_rn(sumsq, inv_c), __fmul_rn(mean, mean));
    const float rstd = rsqrtf(__fadd_rn(var, kLnEps));
    for (int j = lane; j < half_c; j += 32) {
      const float2 a = arow[j];
      const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(a.x, mean), rstd),
                                           lns[2 * j]), lnb[2 * j]);
      const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(a.y, mean), rstd),
                                           lns[2 * j + 1]), lnb[2 * j + 1]);
      const bf162 v = __floats2bfloat162_rn(y0, y1);
      yrow[j] = v;
      if constexpr (Stop == kStopLn) reinterpret_cast<bf162*>(dst + (g0 + i) * c)[j] = v;
    }
  }
  __syncthreads();   // every warp is done with os before the slices overwrite it
  if constexpr (Stop == kStopLn) return;
  mlp.prefetch();

  // 3. fc1 -> GELU -> fc2 into os (or, cut at fc1 / gelu, the first C
  //    columns of the hidden into dst)
  mlp.run(act, dst, row0, row_end);
  if constexpr (!kFc2) return;

  // 4. epilogue, one warp per row: out = bf16(x + (o + b2) * gamma)
  for (int r = warp; r < BM; r += kWarps) {
    const long long g = row0 + r;
    if (g >= row_end) break;
    const bf16* xrow = src + g * c;
    const float* orow = mlp.os + r * mlp.ldo;
    bf16* out = dst + g * c;
    const float* b2 = p.b2 + vb;
    const float* gamma = p.gamma + vb;
    for (int j = lane; j < c; j += 32) {
      const float o = __fmul_rn(__fadd_rn(orow[j], b2[j]), gamma[j]);
      out[j] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(xrow[j]), o));
    }
  }
  __syncthreads();  // os (the ring) and dst are done before the next tile
}

}  // namespace
