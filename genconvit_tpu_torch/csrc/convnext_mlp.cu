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
//     What bounds it on the card: per row the two matmuls do 16*C^2 flops
//     against 6*C bytes (d, x, out in bf16), 2.7*C flop per byte: 256 at
//     C=96, just under the H100's ~295 bf16 ridge, 2048 at C=768. So the
//     bound is HBM at C=96 and the tensor cores from C=192 on (the GELU's f32
//     work, ~20 operations per hidden value, runs beside them). What holds
//     the kernel back in practice is moving the weights from L2 into shared
//     memory once per row tile (a few TB/s across the card), the LayerNorm
//     prologue's and the residual epilogue's memory latency at each tile,
//     and the GELU. A first, WMMA version ran at 4-6% of the bf16 peak: 16-64-row
//     tiles re-read every weight from L2 per tile, a block barrier per
//     32-row weight slice, WMMA fragment loads, and the hidden through
//     shared memory twice.
//     What the design does (the loop in mlp_wgmma.cuh): both products on
//     warpgroup MMA, 128-row tiles (two consumer warpgroups) up to C=384 and
//     64-row tiles above, persistent blocks, the weights by TMA from one
//     producer thread into an mbarrier ring shared by the warpgroups, the
//     two warpgroups taking turns at the tensor cores, and the hidden kept
//     in registers from fc1's accumulator to fc2's A operand, so the
//     [rows, 4C] hidden never reaches shared or device memory. The fc2 sum
//     is split into output-column groups of 96-192 (fc1 recomputed per
//     group), which takes C up to 1536. Each warpgroup's prologue writes its
//     rows' y in wgmma's swizzled layout (8 rows' loads in flight, the next
//     tile's rows and this tile's x asked into L2 ahead); its epilogue works
//     on the fc2 accumulator in registers: the residual add, or the post-LN
//     whose row statistics are summed over a quad's four threads (and over
//     both warpgroups in cols plans; the f32 values of earlier passes kept
//     in a caller-given f32 buffer). The GELU tier is a template argument.
//
// K2  gcv_layer_norm_rows  replaces the Pallas kernel _ln_rows_kernel
//     (entry layer_norm_rows) of the same file: a row LayerNorm with f32
//     statistics and f32 affine, bf16 in and out; on the scoring path it is
//     the stem LN (C=96). One warp per row; it is bound by HBM bandwidth
//     (one read, one write of the rows), so it reads and writes bf16 pairs.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "mlp_wgmma.cuh"

namespace {

constexpr int kThreads = 256;   // K2
constexpr int kWarps = kThreads / 32;

struct MlpArgs {
  const bf16* d;
  const bf16* x;
  const bf16* w1t;    // [4C, C]: (ln_scale (.) W1)^T
  const float* bw;    // [4C]
  const bf16* w2t;    // [C, 4C]: (W2 (.) gamma)^T
  const float* b2g;   // [C]
  const float* lns;   // [C] next-stage LN scale, null without post-LN
  const float* lnb;   // [C]
  float* vbuf;        // [rows, C] f32, post-LN over more than one pass only
  bf16* out;
  long long rows;
  int c;
  int hp;
  int stages;
  int split;          // mlp_wgmma_split: each pass of a tile is a work item
};

// K1's GELU: the plan's rational tier with the fast reciprocal, the tier a
// compile-time choice so that the 32 evaluations of a chunk carry no branch.
template <int HP>
struct GeluTier {
  __device__ __forceinline__ float operator()(float h) const { return gelu_rational(h, HP); }
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Ask L2 for rows [r0, r0 + nrows) of a [rows, c] bf16 tensor (one
// contiguous range), 128-byte lines spread over the warp.
__device__ __forceinline__ void prefetch_rows(const bf16* base, long long r0, int nrows,
                                              long long rows, int c) {
  const long long r1 = r0 + nrows < rows ? r0 + nrows : rows;
  if (r0 >= r1) return;
  const char* p = reinterpret_cast<const char*>(base + r0 * c);
  const long long bytes = (r1 - r0) * c * 2;
  for (long long off = (threadIdx.x % 32) * 128; off < bytes; off += 32 * 128) prefetch_l2(p + off);
}

// A warp's rows [r0, r0 + nrows) of a tile: LayerNorm statistics and y =
// bf16((d - mean) * rstd) into the swizzled y tiles; rows past the ragged
// end and k past C are zero. RB rows at a time, whose loads are in flight
// together; the second pass over d reads it again from L1.
template <int RB>
__device__ __forceinline__ void ln_rows_to_y(const MlpArgs& a, unsigned char* ytiles,
                                             long long row_base, int r0, int nrows, int nkb) {
  const int c = a.c;
  const int lane = threadIdx.x % 32;
  const int half_c = c / 2;
  const float inv_c = 1.0f / static_cast<float>(c);
  for (int rb = 0; rb < nrows; rb += RB) {
    const bf162* drow[RB];
    bool live[RB];
    float sum[RB], sumsq[RB], mean[RB], rstd[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const long long gr = row_base + r0 + rb + i;
      live[i] = gr < a.rows;
      drow[i] = reinterpret_cast<const bf162*>(a.d + (live[i] ? gr : 0) * c);
      sum[i] = sumsq[i] = 0.f;
    }
#pragma unroll 2
    for (int j = lane; j < half_c; j += 32) {
      float2 v[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) v[i] = __bfloat1622float2(drow[i][j]);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        sum[i] += v[i].x + v[i].y;
        sumsq[i] += v[i].x * v[i].x + v[i].y * v[i].y;
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      sum[i] = warp_sum(sum[i]);
      sumsq[i] = warp_sum(sumsq[i]);
      mean[i] = sum[i] * inv_c;
      rstd[i] = rsqrtf(sumsq[i] * inv_c - mean[i] * mean[i] + kLnEps);
    }
    for (int j = lane; j < nkb * 32; j += 32) {
      float2 v[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        v[i] = j < half_c ? __bfloat1622float2(drow[i][j]) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const bf162 y = (live[i] && j < half_c)
                            ? __floats2bfloat162_rn((v[i].x - mean[i]) * rstd[i],
                                                    (v[i].y - mean[i]) * rstd[i])
                            : __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<bf162*>(ytiles + (j / 32) * 8192 +
                                  swz128((r0 + rb + i) % 64, (2 * j) % 64)) = y;
      }
    }
  }
}

// Consumer warpgroup W of a block: every tile's prologue, passes and
// epilogue. In rows plans it owns rows 64 W.. of each 128-row tile; in cols
// plans both share a 64-row tile and W takes groups W, W + 2, ...
template <int NC, bool COLS, bool STREAM, int HP>
__device__ __forceinline__ void mlp_consumer(const MlpArgs& a,
                                             const MlpWgmma<NC, COLS, STREAM>& mlp) {
  const int W = threadIdx.x / 128;
  constexpr int kTile = MlpWgmma<NC, COLS, STREAM>::kRows;
  const int c = a.c;
  const int ww = (threadIdx.x / 32) % 4;   // warp in the warpgroup: rows 16 ww..
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float inv_c = 1.0f / static_cast<float>(c);
  const bool post = a.lns != nullptr;
  const int passes = mlp.passes;
  const int yw = COLS ? 0 : W;
  uint32_t q = 0;
  float o[NC / 2];
  const int nitems = mlp.items(a.rows);
  mlp.turn_end(W, W == 1);   // warpgroup 0 takes the first turn
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const long long tile0 = static_cast<long long>(mlp.item_tile(item)) * kTile;
    const long long row0 = tile0 + (COLS ? 0 : 64 * W);
    const int p0 = mlp.item_pass0(item), p1 = mlp.item_pass1(item);
    const bool last_item = item + gridDim.x >= nitems;

    // 1. y of the tile: rows mode, each warpgroup its own 64 rows (16 a
    //    warp); cols mode, the shared 64 rows (8 a warp), after both
    //    warpgroups are done with the last tile's.
    if constexpr (COLS) {
      bar_sync(2, 256);
      ln_rows_to_y<4>(a, mlp.y_tile(0, 0), tile0, 8 * (4 * W + ww), 8, mlp.nkb);
      fence_proxy_async();
      bar_sync(1, 256);
    } else {
      ln_rows_to_y<8>(a, mlp.y_tile(W, 0), row0 - 64 * W, 64 * W + 16 * ww, 16, mlp.nkb);
      fence_proxy_async();
      bar_sync(1 + W, 128);
    }

    // this tile's x rows (the epilogue's) and the next item's d rows (the
    // next prologue's) into L2 while the passes run
    const int wrows = COLS ? 8 : 16;
    const int wr0 = COLS ? 8 * (4 * W + ww) : 64 * W + 16 * ww;
    prefetch_rows(a.x, tile0 + wr0, wrows, a.rows, c);
    if (!last_item) {
      prefetch_rows(a.d, static_cast<long long>(mlp.item_tile(item + gridDim.x)) * kTile + wr0,
                    wrows, a.rows, c);
    }

    // 2. per pass: fc1 -> GELU -> fc2 (o), then the epilogue on the group's
    //    columns: o[4i + 2h + e] is column grp * NC + 8i + 2t + e of row 16 ww
    //    + g + 8h.
    const long long ra = row0 + 16 * ww + g;
    float rsum[2] = {0.f, 0.f}, rsq[2] = {0.f, 0.f};
    for (int ps = p0; ps < p1; ++ps) {
      if constexpr (STREAM) {
        mlp.pass_stream(W, yw, a.bw, GeluTier<HP>{}, o, q);
      } else {
        mlp.pass(W, yw, a.bw, GeluTier<HP>{}, o, q, last_item && ps == p1 - 1);
      }
      const int grp = COLS ? 2 * ps + W : ps;
      // kB column steps at a time, their x and bias loads issued first
      constexpr int kB = NC == 96 ? 12 : 8;
#pragma unroll
      for (int i0 = 0; i0 < NC / 8; i0 += kB) {
        float2 xv[kB][2], bias[kB];
#pragma unroll
        for (int ii = 0; ii < kB; ++ii) {
          const int col = grp * NC + 8 * (i0 + ii) + 2 * t;
          bias[ii] = col < c ? *reinterpret_cast<const float2*>(a.b2g + col) : make_float2(0.f, 0.f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long r = ra + 8 * h;
            xv[ii][h] = col < c && r < a.rows
                            ? __bfloat1622float2(*reinterpret_cast<const bf162*>(a.x + r * c + col))
                            : make_float2(0.f, 0.f);
          }
        }
#pragma unroll
        for (int ii = 0; ii < kB; ++ii) {
          const int i = i0 + ii;
          const int col = grp * NC + 8 * i + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long r = ra + 8 * h;
            float& v0 = o[4 * i + 2 * h];
            float& v1 = o[4 * i + 2 * h + 1];
            if (!post) {
              const float o0 = __bfloat162float(__float2bfloat16_rn(v0 + bias[ii].x));
              const float o1 = __bfloat162float(__float2bfloat16_rn(v1 + bias[ii].y));
              if (col < c && r < a.rows) {
                *reinterpret_cast<bf162*>(a.out + r * c + col) =
                    __floats2bfloat162_rn(xv[ii][h].x + o0, xv[ii][h].y + o1);
              }
            } else {
              // rows past the end and columns past C hold zeros: they add nothing
              v0 = xv[ii][h].x + (v0 + bias[ii].x);
              v1 = xv[ii][h].y + (v1 + bias[ii].y);
              rsum[h] += v0 + v1;
              rsq[h] += v0 * v0 + v1 * v1;
              if (passes > 1 && col < c && r < a.rows) {
                *reinterpret_cast<float2*>(a.vbuf + r * c + col) = make_float2(v0, v1);
              }
            }
          }
        }
      }
    }
    if (!post) continue;

    // 3. post-LN: a row's columns lie in the four threads of a quad (and, in
    //    cols plans, in both warpgroups: their sums meet in shared memory);
    //    the values come back from registers (one pass) or from this
    //    thread's own vbuf writes.
    float mean[2], rstd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s1 = rsum[h], s2 = rsq[h];
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
      rsum[h] = s1;
      rsq[h] = s2;
    }
    if constexpr (COLS) {
      float* mine = mlp.rowsum + W * 128;
      const float* other = mlp.rowsum + (1 - W) * 128;
      if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mine[2 * (16 * ww + g + 8 * h)] = rsum[h];
          mine[2 * (16 * ww + g + 8 * h) + 1] = rsq[h];
        }
      }
      bar_sync(3, 256);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rsum[h] += other[2 * (16 * ww + g + 8 * h)];
        rsq[h] += other[2 * (16 * ww + g + 8 * h) + 1];
      }
      bar_sync(3, 256);   // both have read before the next tile writes
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = rsum[h] * inv_c;
      rstd[h] = rsqrtf(rsq[h] * inv_c - mean[h] * mean[h] + kLnEps);
    }
    for (int ps = 0; ps < passes; ++ps) {
      const int grp = COLS ? 2 * ps + W : ps;
#pragma unroll
      for (int i = 0; i < NC / 8; ++i) {
        const int col = grp * NC + 8 * i + 2 * t;
        if (col >= c) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = ra + 8 * h;
          if (r >= a.rows) continue;
          float2 v = make_float2(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
          if (passes > 1) v = *reinterpret_cast<const float2*>(a.vbuf + r * c + col);
          *reinterpret_cast<bf162*>(a.out + r * c + col) = __floats2bfloat162_rn(
              (v.x - mean[h]) * rstd[h] * a.lns[col] + a.lnb[col],
              (v.y - mean[h]) * rstd[h] * a.lns[col + 1] + a.lnb[col + 1]);
        }
      }
    }
  }
}

template <int NC, bool COLS, bool STREAM, int HP>
__global__ void __launch_bounds__(kMlpThreads, 1)
ln_mlp_residual_kernel(const MlpArgs a, const __grid_constant__ CUtensorMap tm1,
                       const __grid_constant__ CUtensorMap tm2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const MlpWgmma<NC, COLS, STREAM> mlp(align1024(smem_raw), a.c, a.stages, a.split != 0);
  if (threadIdx.x == 0) mlp.init_barriers();
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    // the producer warpgroup streams; most of its registers go to the
    // consumers (2 x 128 x 224 + 128 x 56 = 168 x 384)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == 256) mlp.produce(&tm1, &tm2, blockIdx.x, gridDim.x, mlp.items(a.rows));
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    mlp_consumer<NC, COLS, STREAM, HP>(a, mlp);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no driver
// library at link time).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A 2-D map of a row-major bf16 [outer, inner] matrix in boxes of
// box_outer x 64, 128-byte swizzled, zero past the edges.
int bf16_box_map(CUtensorMap* map, const void* base, int inner, int outer, int box_outer) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NC, bool COLS, bool STREAM, int HP>
int launch_mlp_tier(const MlpArgs& a, const MlpPlan& p, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = static_cast<size_t>(p.smem);
  const int err =
      raise_smem_limit(ln_mlp_residual_kernel<NC, COLS, STREAM, HP>, smem, &smem_configured);
  if (err) return err;
  CUtensorMap tm1, tm2;
  int e = bf16_box_map(&tm1, a.w1t, a.c, 4 * a.c, 64);
  if (e == 0) e = bf16_box_map(&tm2, a.w2t, 4 * a.c, a.c, NC);
  if (e) return e;
  // work items as the kernel counts them (MlpWgmma::items)
  const long long items = (a.rows + p.rows - 1) / p.rows * (a.split ? mlp_wgmma_passes(a.c, p) : 1);
  const long long blocks = items < sm_count() ? items : sm_count();
  ln_mlp_residual_kernel<NC, COLS, STREAM, HP>
      <<<static_cast<unsigned int>(blocks), kMlpThreads, smem, stream>>>(a, tm1, tm2);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, bool COLS, bool STREAM = false>
int launch_mlp(const MlpArgs& a, const MlpPlan& p, cudaStream_t stream) {
  return a.hp ? launch_mlp_tier<NC, COLS, STREAM, 1>(a, p, stream)
              : launch_mlp_tier<NC, COLS, STREAM, 0>(a, p, stream);
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

// K1's tile plan at width c: out = {rows per block, output columns per
// group, ring stages, shared-memory bytes}; returns 0 where K1 does not
// take c (a multiple of 32 in [32, 1536]).
int gcv_mlp_plan(int c, int* out) {
  const MlpPlan p = mlp_wgmma_plan(c);
  out[0] = p.rows;
  out[1] = p.cols;
  out[2] = p.stages;
  out[3] = p.smem;
  return p.rows != 0;
}

const char* gcv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1. c must be one gcv_mlp_plan takes (the caller checks); lns/lnb null
// selects the plain residual epilogue; vbuf [rows, c] f32 is needed with
// post-LN when the plan makes more than one pass (mlp_wgmma_passes), else
// may be null.
int gcv_ln_mlp_residual(const void* d, const void* x, const void* w1t, const void* bw,
                        const void* w2t, const void* b2g, const void* lns,
                        const void* lnb, void* vbuf, void* out, long long rows, int c, int hp,
                        void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const MlpPlan p = mlp_wgmma_plan(c);
  if (p.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  MlpArgs a;
  a.d = static_cast<const bf16*>(d);
  a.x = static_cast<const bf16*>(x);
  a.w1t = static_cast<const bf16*>(w1t);
  a.bw = static_cast<const float*>(bw);
  a.w2t = static_cast<const bf16*>(w2t);
  a.b2g = static_cast<const float*>(b2g);
  a.lns = static_cast<const float*>(lns);
  a.lnb = static_cast<const float*>(lnb);
  a.vbuf = static_cast<float*>(vbuf);
  a.out = static_cast<bf16*>(out);
  a.rows = rows;
  a.c = c;
  a.hp = hp;
  a.stages = p.stages;
  a.split = mlp_wgmma_split(c, p, rows, a.lns != nullptr, sm_count());
  if (a.lns != nullptr && mlp_wgmma_passes(c, p) > 1 && a.vbuf == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.rows == 128) {
    switch (p.cols) {
      case 96: return launch_mlp<96, false>(a, p, s);
      case 128: return launch_mlp<128, false>(a, p, s);
      default: return launch_mlp<192, false>(a, p, s);
    }
  }
  if (mlp_wgmma_stream(c, p)) {
    return p.cols == 128 ? launch_mlp<128, true, true>(a, p, s) : launch_mlp<192, true, true>(a, p, s);
  }
  return p.cols == 128 ? launch_mlp<128, true>(a, p, s) : launch_mlp<192, true>(a, p, s);
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
