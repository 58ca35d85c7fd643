// Hand-written Hopper (sm_90a) kernel for the ConvNeXt block tail, with a
// plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/convnext_mlp.py). No PyTorch headers. K2,
// the stem LayerNorm of the same Pallas file, is layer_norm_rows.cu.
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
//     Routing: where that loop makes more than one pass (C from 224 up:
//     mlp_wgmma_passes > 1) and no post-LN is asked for, it would compute
//     fc1 once per pass (twice per pass in cols plans, both warpgroups on
//     one y tile) and stream every weight from L2 per pass; those calls take
//     the ordered route instead (mlp_ordered.cuh: LN, fc1 and fc2 tiles of
//     one persistent launch, the hidden written once to a scratch and read
//     back by TMA, each row block's from L2 after its first tile). The rest
//     keep the fused loop: C up to 192, where one pass holds the hidden in
//     registers, and the post-LN launches (the last block of a stage), whose
//     epilogue needs a row's every column in one block. The choice reads
//     only C and whether a post-LN is asked for; the wrapper makes it
//     (convnext_mlp.k1_route), since it allocates the route's scratch, and
//     a call that passes the scratch takes the route (launch_k1_ordered
//     refuses a width or a post-LN the route does not take).
//
// Every entry point returns cudaGetLastError() after its launch.

#include "mlp_ordered.cuh"
#include "mlp_wgmma.cuh"

namespace {

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
  float eps;          // the LayerNorms' (the row statistics and the post-LN)
};

// K1's chunk functor (MlpWgmma::pass): the bias of chunk j loaded before
// its products are issued, then bias + GELU in registers, rounded to bf16:
// fc2's A fragments. z[4i + e] is hidden column 64j + 8i + 2t + e of row g,
// z[4i + 2 + e] of row g + 8; k16 step s takes i = 2s (k 2t..) and 2s + 1
// (k 2t + 8..). The GELU tier is a compile-time choice, so that the 32
// evaluations of a chunk carry no branch.
template <int HP>
struct K1Chunk {
  const float* b1;
  float2 bias[8];

  __device__ __forceinline__ void load(int j) {
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) bias[i] = *reinterpret_cast<const float2*>(b1 + 64 * j + 8 * i + 2 * t);
  }

  __device__ __forceinline__ void convert(const float* z, uint32_t (*hf)[4]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bf162 ha = __floats2bfloat162_rn(gelu_rational(z[4 * i] + bias[i].x, HP),
                                             gelu_rational(z[4 * i + 1] + bias[i].y, HP));
      const bf162 hb = __floats2bfloat162_rn(gelu_rational(z[4 * i + 2] + bias[i].x, HP),
                                             gelu_rational(z[4 * i + 3] + bias[i].y, HP));
      hf[i / 2][(i % 2) * 2] = bf162_bits(ha);
      hf[i / 2][(i % 2) * 2 + 1] = bf162_bits(hb);
    }
  }
};

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
      rstd[i] = rsqrtf(sumsq[i] * inv_c - mean[i] * mean[i] + a.eps);
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

// What mlp_consumer needs of K1 (mlp_wgmma.cuh): its arguments, the bf16
// prologue, the chunk functor; nothing happens per tile or after fc2.
template <int HP>
struct K1Tail {
  const MlpArgs& a;

  template <int RB>
  __device__ __forceinline__ void rows_to_y(unsigned char* ytiles, long long row_base, int r0,
                                            int nrows, int nkb, float*) const {
    ln_rows_to_y<RB>(a, ytiles, row_base, r0, nrows, nkb);
  }
  __device__ __forceinline__ K1Chunk<HP> chunk() const { return K1Chunk<HP>{a.bw}; }
  __device__ __forceinline__ void begin_rows(K1Chunk<HP>&, const float*) const {}
  __device__ __forceinline__ void fc2_done(K1Chunk<HP>&, float*, int) const {}
};

template <int NC, bool COLS, bool STREAM, int HP>
__global__ void __launch_bounds__(kMlpThreads, 1)
ln_mlp_residual_kernel(const MlpArgs a, const __grid_constant__ CUtensorMap tm1,
                       const __grid_constant__ CUtensorMap tm2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const MlpWgmma<NC, COLS, STREAM> mlp(align1024(smem_raw), a.c, a.stages, a.split != 0);
  mlp_block(K1Tail<HP>{a}, mlp, &tm1, &tm2);
}

template <int NC, bool COLS, bool STREAM, int HP>
int launch_mlp_tier(const MlpArgs& a, const MlpPlan& p, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = static_cast<size_t>(p.smem);
  const int err =
      raise_smem_limit(ln_mlp_residual_kernel<NC, COLS, STREAM, HP>, smem, &smem_configured);
  if (err) return err;
  CUtensorMap tm1, tm2;
  int e = box_map(&tm1, a.w1t, 2, a.c, 4 * a.c, 128, 64);
  if (e == 0) e = box_map(&tm2, a.w2t, 2, 4 * a.c, a.c, 128, NC);
  if (e) return e;
  // work items as the kernel counts them (MlpWgmma::items)
  const long long items = (a.rows + p.rows - 1) / p.rows * (a.split ? mlp_wgmma_passes(a.c, p) : 1);
  const long long blocks = items < sm_count() ? items : sm_count();
  ln_mlp_residual_kernel<NC, COLS, STREAM, HP>
      <<<static_cast<unsigned int>(blocks), kMlpThreads, smem, stream>>>(a, tm1, tm2);
  return static_cast<int>(cudaGetLastError());
}

// K1 on the ordered route (see the note at the top): only where the fused
// plan makes more than one pass; ybuf [rows, c] and hbuf [rows, 4c] bf16 are
// its scratch and flags its readiness words (2 + ceil(rows / 128) (1 + c /
// 32) u64, zero before the first launch on them), gen a generation not used
// before on those flags (never 0; 64 bits, so it never wraps). plant: 0, or
// launch_ordered's planted faults.
int launch_k1_ordered(const void* d, const void* x, const void* w1t, const void* bw,
                      const void* w2t, const void* b2g, void* out, void* ybuf, void* hbuf,
                      void* flags, long long rows, int c, int hp, float eps,
                      unsigned long long gen, int plant, void* stream) {
  const MlpPlan p = mlp_wgmma_plan(c);
  if (p.rows == 0 || mlp_wgmma_passes(c, p) < 2 || ybuf == nullptr || hbuf == nullptr ||
      flags == nullptr || gen == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  OrdArgs o;
  o.d = static_cast<const bf16*>(d);
  o.x = static_cast<const bf16*>(x);
  o.bw = static_cast<const float*>(bw);
  o.b2g = static_cast<const float*>(b2g);
  o.y = static_cast<bf16*>(ybuf);
  o.h = static_cast<bf16*>(hbuf);
  o.out = static_cast<bf16*>(out);
  o.flags = static_cast<unsigned long long*>(flags);
  o.rows = rows;
  o.c = c;
  o.mblocks = static_cast<int>((rows + kOrdRows - 1) / kOrdRows);
  o.n1 = 4 * c / kOrdCols;
  o.n2 = (c + kOrdCols - 1) / kOrdCols;
  o.nk1 = (c + 63) / 64;
  o.nk2 = c / 16;
  o.eps = eps;
  o.gen = gen;
  o.plant = plant;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hp ? launch_ordered<1>(o, w1t, w2t, s) : launch_ordered<0>(o, w1t, w2t, s);
}

template <int NC, bool COLS, bool STREAM = false>
int launch_mlp(const MlpArgs& a, const MlpPlan& p, cudaStream_t stream) {
  return a.hp ? launch_mlp_tier<NC, COLS, STREAM, 1>(a, p, stream)
              : launch_mlp_tier<NC, COLS, STREAM, 0>(a, p, stream);
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
// may be null. Passing ybuf, hbuf and flags takes the ordered route
// (launch_k1_ordered: no post-LN, more than one pass, gen as it says);
// else they are null and gen is not read. eps: the LayerNorms' (ConvNeXt's
// 1e-6, Swin's 1e-5), of the row statistics and of the post-LN alike.
int gcv_ln_mlp_residual(const void* d, const void* x, const void* w1t, const void* bw,
                        const void* w2t, const void* b2g, const void* lns,
                        const void* lnb, void* vbuf, void* out, void* ybuf, void* hbuf,
                        void* flags, long long rows, int c, int hp, float eps,
                        unsigned long long gen, void* stream) {
  if (ybuf != nullptr || hbuf != nullptr || flags != nullptr) {
    if (lns != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_k1_ordered(d, x, w1t, bw, w2t, b2g, out, ybuf, hbuf, flags, rows, c, hp, eps,
                             gen, 0, stream);
  }
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
  a.eps = eps;
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

// K1's ordered route with planted faults, for the card tests: plant 1 skips
// the readiness waits, 2 hands the items out in row order (launch_ordered).
int gcv_ln_mlp_residual_planted(const void* d, const void* x, const void* w1t, const void* bw,
                                const void* w2t, const void* b2g, void* out, void* ybuf,
                                void* hbuf, void* flags, long long rows, int c, int hp,
                                float eps, unsigned long long gen, int plant, void* stream) {
  return launch_k1_ordered(d, x, w1t, bw, w2t, b2g, out, ybuf, hbuf, flags, rows, c, hp, eps,
                           gen, plant, stream);
}

}  // extern "C"
