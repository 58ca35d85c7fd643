// K4's kernel (the note at the top of convnext_mlp_int8.cu), its tile plan
// and its launch, shared by the two translation units that instantiate it,
// one per mode, so that they build in parallel: convnext_mlp_int8.cu
// ('fc1', the plan's and the launch's C entry points) and
// convnext_mlp_int8_full.cu ('full').
#pragma once

#include "mlp_wgmma.cuh"

namespace {

constexpr float kActQ = 127.0f / 8.0f;   // 'fc1' mode's fixed y scale

struct Int8Args {
  const bf16* d;
  const bf16* x;
  const int8_t* wq1;   // [4C, C]
  const float* s1;     // [4C]
  const float* bw;     // [4C]
  const bf16* w2t;     // 'fc1': [C, 4C] bf16, w2g transposed
  const int8_t* wq2k;  // 'full': [C, 4C] int8, k in kernel order
  const float* s2;     // 'full': [C]
  const float* b2g;    // [C]
  const float* lns;    // [C] next-stage LN scale, null without post-LN
  const float* lnb;
  float* vbuf;         // [rows, C] f32, post-LN over more than one pass only
  bf16* out;
  long long rows;
  int c;
  int hp;
  int stages;
  int split;           // each pass of a tile is a work item (k4_launch_plan)
  float eps;           // the post-LN's (mlp_wgmma.cuh reads it): kLnEps
};

// K4's tile plan at width c and mode: rows per block (128: "rows", 64:
// "cols"), output columns per group (NC), w1t tiles per fc1 stage (KB),
// ring stages and shared-memory bytes; rows 0 where c is not a multiple of
// 32 in [32, 1536]. Candidates are the (rows, NC, KB) the kernel is built
// for; one is taken only where its ring holds a turn (every fc1 stage of a
// chunk and its fc2 stages), and the cheapest wins: the weight bytes a
// 128-row tile streams from L2 (370 tensor operations' time a byte: ~2.7
// TB/s against ~1 POP/s), plus the operations of both products (bf16 at
// twice the int8 cost), fc1 once per pass and, in 'full', once more for the
// row maxima. The cost does not see KB: 'full' has only the 2-tile fc1
// stage at NC = 192 (at C = 768 and the ED call's rows it took a sixth off a
// launch against 1-tile stages on the card).
struct K4Plan {
  int rows, cols, kbs, stages, smem;
};

constexpr int kK4Fc1Cands[7][3] = {{128, 192, 1}, {128, 192, 2}, {128, 128, 1}, {128, 128, 2},
                                   {128, 96, 1},  {64, 192, 2},  {64, 128, 2}};
constexpr int kK4FullCands[4][3] = {{128, 192, 2}, {128, 128, 1}, {128, 96, 1}, {64, 192, 2}};

// A candidate's ring: its stages and shared memory, rows 0 where the ring
// does not hold a turn (every fc1 stage of a chunk and its fc2 stages).
inline K4Plan k4_candidate(int c, bool full, const int* cand) {
  const int nkb = (c + 127) / 128;
  K4Plan p = {cand[0], cand[1], cand[2], 0, 0};
  const int ybytes = p.rows * nkb * 128;
  const int fc2 = full ? p.cols * 64 : p.cols * 128;
  const int stage = p.kbs * 8192 > fc2 ? p.kbs * 8192 : fc2;
  p.stages = (kSmemMax - 1024 - ybytes - kMlpMisc - kMlpRowScales) / stage;
  if (p.stages > 8) p.stages = 8;
  p.smem = 1024 + ybytes + p.stages * stage + kMlpMisc + kMlpRowScales;
  if (p.kbs > nkb || p.stages < (nkb + p.kbs - 1) / p.kbs + (p.rows == 128 ? 1 : 2)) p.rows = 0;
  return p;
}

inline K4Plan k4_plan(int c, bool full) {
  K4Plan best = {0, 0, 0, 0, 0};
  if (c < 32 || c > 1536 || c % 32 != 0) return best;
  long long best_cost = 0;
  for (int i = 0; i < (full ? 4 : 7); ++i) {
    const K4Plan p = k4_candidate(c, full, full ? kK4FullCands[i] : kK4Fc1Cands[i]);
    if (p.rows == 0) continue;
    const long long cc = c;
    const long long groups = (c + p.cols - 1) / p.cols;
    const long long passes = p.rows == 128 ? groups : (groups + 1) / 2;
    const long long tiles = 128 / p.rows;
    const long long runs = passes + (full ? 1 : 0);   // fc1 runs per tile
    const long long wbytes =
        tiles * runs * 4 * cc * cc + tiles * 4 * cc * groups * p.cols * (full ? 1 : 2);
    const long long ops = runs * 2 * tiles * 64 * cc * 4 * cc * 2 +
                          128 * 4 * cc * groups * p.cols * 2 * (full ? 1 : 2);
    const long long cost = wbytes * 370 + ops;
    if (best.rows == 0 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

__host__ __device__ inline int k4_passes(int c, const K4Plan& p) {
  const int groups = (c + p.cols - 1) / p.cols;
  return p.rows == 128 ? groups : (groups + 1) / 2;
}

// Rounds of work items over the SMs, each as long as one fc1 run of a
// warpgroup (with its fc2 group): a whole tile runs all its passes ('full':
// and the row-maxima pass), a split item (each pass of a tile an item of
// its own) one pass ('full': and its own row-maxima pass).
inline long long k4_rounds(int c, const K4Plan& p, long long rows, bool full, bool split,
                           int sms) {
  const long long passes = k4_passes(c, p);
  const long long tiles = (rows + p.rows - 1) / p.rows;
  return split ? (tiles * passes + sms - 1) / sms * (full ? 2 : 1)
               : (tiles + sms - 1) / sms * (passes + (full ? 1 : 0));
}

// The plan of one launch (few rows: the late stages, the small
// reconstructions). Without the post-LN, which needs every column of a row
// in one block: where k4_plan's 128-row tiles would leave more than half
// of the SMs idle, the mode's cols plan, whose 64-row tiles spread wider
// at the cost of fc1 run by both warpgroups and the weights streamed per 64
// rows; and in a cols plan, each pass of a tile a work item of its own
// where that takes at most 0.8 of the rounds (an item pays its own
// prologue and pipeline fill: on the card, at a tenth fewer rounds it did
// not pay).
inline K4Plan k4_launch_plan(int c, bool full, long long rows, bool post, int sms,
                             bool* split) {
  *split = false;
  K4Plan p = k4_plan(c, full);
  if (p.rows == 0 || post) return p;
  if (p.rows == 128 && 2 * ((rows + 127) / 128) <= sms) {
    for (int i = 0; i < (full ? 4 : 7); ++i) {
      const int* cand = full ? kK4FullCands[i] : kK4Fc1Cands[i];
      if (cand[0] != 64) continue;
      const K4Plan q = k4_candidate(c, full, cand);
      if (q.rows != 0) {
        p = q;
        break;
      }
    }
  }
  *split = p.rows == 64 && k4_passes(c, p) > 1 &&
           5 * k4_rounds(c, p, rows, full, true, sms) <= 4 * k4_rounds(c, p, rows, full, false, sms);
  return p;
}

__device__ __forceinline__ int clip127(int v) { return v > 127 ? 127 : v < -127 ? -127 : v; }

__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  const float2 lo = __bfloat1622float2(bf162_from_bits(u.x));
  const float2 hi = __bfloat1622float2(bf162_from_bits(u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// A warp's rows [r0, r0 + nrows) of a tile: LayerNorm statistics and y
// quantized to int8 into the swizzled y tiles (4 k a lane), with the fixed
// scale ('fc1') or the row's own ('full': its max |y| from the max and min
// of d, since y is monotonic in d; the y scale sa into rowscale[r0 + ..]).
// Rows past the ragged end and k past C are zero. RB rows at a time, whose
// loads are in flight together; the second pass over d reads it from L1.
template <int RB, bool FULL>
__device__ __forceinline__ void ln_rows_to_yq(const Int8Args& a, unsigned char* ytiles,
                                              long long row_base, int r0, int nrows, int nkb,
                                              float* rowscale) {
  const int c = a.c;
  const int lane = threadIdx.x % 32;
  const int quarter_c = c / 4;
  const float inv_c = 1.0f / static_cast<float>(c);
  for (int rb = 0; rb < nrows; rb += RB) {
    const uint2* drow[RB];
    bool live[RB];
    float sum[RB], sumsq[RB], vmax[RB], vmin[RB], mean[RB], rstd[RB], k[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const long long gr = row_base + r0 + rb + i;
      live[i] = gr < a.rows;
      drow[i] = reinterpret_cast<const uint2*>(a.d + (live[i] ? gr : 0) * c);
      sum[i] = sumsq[i] = 0.f;
      vmax[i] = -3.0e38f;
      vmin[i] = 3.0e38f;
    }
#pragma unroll 2
    for (int j = lane; j < quarter_c; j += 32) {
      float4 v[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) v[i] = bf16x4_to_float4(drow[i][j]);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        sum[i] += (v[i].x + v[i].y) + (v[i].z + v[i].w);
        sumsq[i] += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
        if constexpr (FULL) {
          vmax[i] = fmaxf(vmax[i], fmaxf(fmaxf(v[i].x, v[i].y), fmaxf(v[i].z, v[i].w)));
          vmin[i] = fminf(vmin[i], fminf(fminf(v[i].x, v[i].y), fminf(v[i].z, v[i].w)));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      sum[i] = warp_sum(sum[i]);
      sumsq[i] = warp_sum(sumsq[i]);
      mean[i] = sum[i] * inv_c;
      rstd[i] = rsqrtf(sumsq[i] * inv_c - mean[i] * mean[i] + kLnEps);
      k[i] = kActQ;
      if constexpr (FULL) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          vmax[i] = fmaxf(vmax[i], __shfl_xor_sync(0xffffffffu, vmax[i], o));
          vmin[i] = fminf(vmin[i], __shfl_xor_sync(0xffffffffu, vmin[i], o));
        }
        const float amax = fmaxf(fmaxf(fabsf((vmax[i] - mean[i]) * rstd[i]),
                                       fabsf((vmin[i] - mean[i]) * rstd[i])), 1e-30f);
        k[i] = 127.0f / amax;
        if (lane == 0) rowscale[r0 + rb + i] = live[i] ? amax * (1.0f / 127.0f) : 0.0f;
      }
    }
    for (int j = lane; j < nkb * 32; j += 32) {
      float4 v[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        v[i] = j < quarter_c ? bf16x4_to_float4(drow[i][j]) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        uint32_t packed = 0;
        if (live[i] && j < quarter_c) {
          const float m = mean[i], r = rstd[i], kk = k[i];
          packed = pack_s8x4(clip127(__float2int_rn(__fmul_rn((v[i].x - m) * r, kk))),
                             clip127(__float2int_rn(__fmul_rn((v[i].y - m) * r, kk))),
                             clip127(__float2int_rn(__fmul_rn((v[i].z - m) * r, kk))),
                             clip127(__float2int_rn(__fmul_rn((v[i].w - m) * r, kk))));
        }
        *reinterpret_cast<uint32_t*>(ytiles + (j / 32) * 8192 +
                                     swz128_byte((r0 + rb + i) % 64, (4 * j) % 128)) = packed;
      }
    }
  }
}

// K4's chunk functor (MlpWgmma::pass, pass_max). z[4i + e] is the s32 sum
// of hidden column 64j + 8i + 2t + e % 2 of row g + 8 (e / 2); h is its
// dequantized GELU. convert: 'fc1', h rounded to bf16 pairs as K1's; 'full',
// h quantized with the row's 127 / max|h| into s8 k32 fragments (step s,
// register 2hh + row half: z columns i = 4s + 2hh and 4s + 2hh + 1, the
// kernel order of wq2k). reduce: the running max|h| of both rows (pass_max),
// end_max: over the quad, then the row's scales.
template <int HP, bool FULL>
struct K4Chunk {
  const float* s1;
  const float* bw;
  int j;
  float sa[2];     // 'full': the y scales of rows g, g + 8
  float hmax[2];   // 'full': max|h| of those rows
  float qinv[2];   // 'full': 127 / max|h|
  float sb[2];     // 'full': max|h| / 127

  __device__ __forceinline__ void load(int jj) { j = jj; }

  __device__ __forceinline__ float h_of(int zv, float s, float b, int half) const {
    float zf = static_cast<float>(zv);
    if constexpr (FULL) zf = __fmul_rn(zf, sa[half]);
    return gelu_rational(__fadd_rn(__fmul_rn(zf, s), b), HP);
  }

  __device__ __forceinline__ void convert(const int* z, uint32_t (*hf)[4]) const {
    const int t = threadIdx.x % 4;
    if constexpr (!FULL) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * j + 8 * i + 2 * t;
        const float2 s = *reinterpret_cast<const float2*>(s1 + col);
        const float2 b = *reinterpret_cast<const float2*>(bw + col);
        const bf162 ha = __floats2bfloat162_rn(h_of(z[4 * i], s.x, b.x, 0),
                                               h_of(z[4 * i + 1], s.y, b.y, 0));
        const bf162 hb = __floats2bfloat162_rn(h_of(z[4 * i + 2], s.x, b.x, 1),
                                               h_of(z[4 * i + 3], s.y, b.y, 1));
        hf[i / 2][(i % 2) * 2] = bf162_bits(ha);
        hf[i / 2][(i % 2) * 2 + 1] = bf162_bits(hb);
      }
    } else {
#pragma unroll
      for (int st = 0; st < 2; ++st) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          int qv[8];   // z columns i0 = 4st + 2hh and i0 + 1, rows g (e < 2) and g + 8
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = 4 * st + 2 * hh + u;
            const int col = 64 * j + 8 * i + 2 * t;
            const float2 s = *reinterpret_cast<const float2*>(s1 + col);
            const float2 b = *reinterpret_cast<const float2*>(bw + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float h = h_of(z[4 * i + e], e % 2 ? s.y : s.x, e % 2 ? b.y : b.x, e / 2);
              qv[4 * u + e] = clip127(__float2int_rn(__fmul_rn(h, qinv[e / 2])));
            }
          }
          hf[st][2 * hh] = pack_s8x4(qv[0], qv[1], qv[4], qv[5]);
          hf[st][2 * hh + 1] = pack_s8x4(qv[2], qv[3], qv[6], qv[7]);
        }
      }
    }
  }

  __device__ __forceinline__ void reduce(const int* z) {
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * j + 8 * i + 2 * t;
      const float2 s = *reinterpret_cast<const float2*>(s1 + col);
      const float2 b = *reinterpret_cast<const float2*>(bw + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = h_of(z[4 * i + e], e % 2 ? s.y : s.x, e % 2 ? b.y : b.x, e / 2);
        hmax[e / 2] = fmaxf(hmax[e / 2], fabsf(h));
      }
    }
  }

  __device__ __forceinline__ void end_max() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = hmax[h];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      m = fmaxf(m, 1e-30f);
      qinv[h] = 127.0f / m;
      sb[h] = m * (1.0f / 127.0f);
    }
  }
};

// What mlp_consumer needs of K4 (mlp_wgmma.cuh): its arguments, the int8
// prologue, the chunk functor with its rows' y scales ('full'), and in
// 'full' the fc2 sums dequantized to f32 before the epilogue: o * sb * s2
// (s2 zero past C).
template <int HP, bool FULL>
struct K4Tail {
  const Int8Args& a;

  template <int RB>
  __device__ __forceinline__ void rows_to_y(unsigned char* ytiles, long long row_base, int r0,
                                            int nrows, int nkb, float* rowscale) const {
    ln_rows_to_yq<RB, FULL>(a, ytiles, row_base, r0, nrows, nkb, rowscale);
  }

  __device__ __forceinline__ K4Chunk<HP, FULL> chunk() const {
    K4Chunk<HP, FULL> ch;
    ch.s1 = a.s1;
    ch.bw = a.bw;
    ch.j = 0;
    return ch;
  }

  // rs: the y scale of this thread's row g (rs[0]) and row g + 8 (rs[8])
  __device__ __forceinline__ void begin_rows(K4Chunk<HP, FULL>& ch, const float* rs) const {
    if constexpr (FULL) {
      ch.sa[0] = rs[0];
      ch.sa[1] = rs[8];
      ch.hmax[0] = ch.hmax[1] = 0.0f;
    }
  }

  template <class Acc, int N>
  __device__ __forceinline__ void fc2_done(const K4Chunk<HP, FULL>& ch, Acc (&o)[N],
                                           int col0) const {
    if constexpr (FULL) {
      const int t = threadIdx.x % 4;
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const int col = col0 + 8 * i + 2 * t;
        const float2 s = col < a.c ? *reinterpret_cast<const float2*>(a.s2 + col)
                                   : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * i + 2 * h] = __float_as_int(
              __fmul_rn(__fmul_rn(static_cast<float>(o[4 * i + 2 * h]), ch.sb[h]), s.x));
          o[4 * i + 2 * h + 1] = __float_as_int(
              __fmul_rn(__fmul_rn(static_cast<float>(o[4 * i + 2 * h + 1]), ch.sb[h]), s.y));
        }
      }
    }
  }
};

template <bool FULL>
struct K4Fc2 {
  using type = Fc2Bf16;
};
template <>
struct K4Fc2<true> {
  using type = Fc2S8;
};

// SPLIT is a compile-time choice: as a run-time flag, the work-item loop
// it steers costs the cols instantiations hundreds of bytes of spills.
template <int NC, bool COLS, int KB, bool FULL, int HP, bool SPLIT>
__global__ void __launch_bounds__(kMlpThreads, 1)
ln_mlp_residual_int8_kernel(const Int8Args a, const __grid_constant__ CUtensorMap tm1,
                            const __grid_constant__ CUtensorMap tm2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const MlpWgmma<NC, COLS, false, Fc1S8, typename K4Fc2<FULL>::type, KB> mlp(
      align1024(smem_raw), a.c, a.stages, SPLIT);
  mlp_block(K4Tail<HP, FULL>{a}, mlp, &tm1, &tm2);
}

template <int NC, bool COLS, int KB, bool FULL, int HP, bool SPLIT>
int launch_k4_tier(const Int8Args& a, const K4Plan& p, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = static_cast<size_t>(p.smem);
  const int err = raise_smem_limit(ln_mlp_residual_int8_kernel<NC, COLS, KB, FULL, HP, SPLIT>,
                                   smem, &smem_configured);
  if (err) return err;
  CUtensorMap tm1, tm2;
  int e = box_map(&tm1, a.wq1, 1, a.c, 4 * a.c, 128, 64);
  if (e == 0) {
    e = FULL ? box_map(&tm2, a.wq2k, 1, 4 * a.c, a.c, 64, NC)
             : box_map(&tm2, a.w2t, 2, 4 * a.c, a.c, 128, NC);
  }
  if (e) return e;
  // work items as the kernel counts them (MlpWgmma::items)
  const long long items = (a.rows + p.rows - 1) / p.rows * (a.split ? k4_passes(a.c, p) : 1);
  const long long blocks = items < sm_count() ? items : sm_count();
  ln_mlp_residual_int8_kernel<NC, COLS, KB, FULL, HP, SPLIT>
      <<<static_cast<unsigned int>(blocks), kMlpThreads, smem, stream>>>(a, tm1, tm2);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, bool COLS, int KB, bool FULL, bool SPLIT>
int launch_k4_split(const Int8Args& a, const K4Plan& p, cudaStream_t stream) {
  return a.hp ? launch_k4_tier<NC, COLS, KB, FULL, 1, SPLIT>(a, p, stream)
              : launch_k4_tier<NC, COLS, KB, FULL, 0, SPLIT>(a, p, stream);
}

// rows plans never split (k4_launch_plan)
template <int NC, bool COLS, int KB, bool FULL>
int launch_k4(const Int8Args& a, const K4Plan& p, cudaStream_t stream) {
  if constexpr (COLS) {
    if (a.split) return launch_k4_split<NC, COLS, KB, FULL, true>(a, p, stream);
  }
  return launch_k4_split<NC, COLS, KB, FULL, false>(a, p, stream);
}

// The instantiation of plan p (one of k4_plan's candidates) of mode FULL.
template <bool FULL>
int launch_k4_mode(const Int8Args& a, const K4Plan& p, cudaStream_t s) {
  if constexpr (!FULL) {
    if (p.rows == 64) {
      return p.cols == 192 ? launch_k4<192, true, 2, false>(a, p, s)
                           : launch_k4<128, true, 2, false>(a, p, s);
    }
    if (p.cols == 192) {
      return p.kbs == 1 ? launch_k4<192, false, 1, false>(a, p, s)
                        : launch_k4<192, false, 2, false>(a, p, s);
    }
    if (p.cols == 128) {
      return p.kbs == 1 ? launch_k4<128, false, 1, false>(a, p, s)
                        : launch_k4<128, false, 2, false>(a, p, s);
    }
    return launch_k4<96, false, 1, false>(a, p, s);
  } else {
    if (p.rows == 64) return launch_k4<192, true, 2, true>(a, p, s);
    switch (p.cols) {
      case 192: return launch_k4<192, false, 2, true>(a, p, s);
      case 128: return launch_k4<128, false, 1, true>(a, p, s);
      default: return launch_k4<96, false, 1, true>(a, p, s);
    }
  }
}

// gcv_ln_mlp_residual_int8 (convnext_mlp_int8.cu) in mode FULL: the launch
// plan, the arguments, the launch.
template <bool FULL>
int k4_launch(const void* d, const void* x, const void* wq1, const void* s1, const void* bw,
              const void* w2t, const void* wq2k, const void* s2, const void* b2g,
              const void* lns, const void* lnb, void* vbuf, void* out, long long rows, int c,
              int hp, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  bool split = false;
  const K4Plan p = k4_launch_plan(c, FULL, rows, lns != nullptr, sm_count(), &split);
  if (p.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  Int8Args a;
  a.d = static_cast<const bf16*>(d);
  a.x = static_cast<const bf16*>(x);
  a.wq1 = static_cast<const int8_t*>(wq1);
  a.s1 = static_cast<const float*>(s1);
  a.bw = static_cast<const float*>(bw);
  a.w2t = static_cast<const bf16*>(w2t);
  a.wq2k = static_cast<const int8_t*>(wq2k);
  a.s2 = static_cast<const float*>(s2);
  a.b2g = static_cast<const float*>(b2g);
  a.lns = static_cast<const float*>(lns);
  a.lnb = static_cast<const float*>(lnb);
  a.vbuf = static_cast<float*>(vbuf);
  a.out = static_cast<bf16*>(out);
  a.rows = rows;
  a.c = c;
  a.hp = hp;
  a.stages = p.stages;
  a.split = split;
  a.eps = kLnEps;
  if ((FULL ? a.wq2k == nullptr || a.s2 == nullptr : a.w2t == nullptr) ||
      (a.lns != nullptr && k4_passes(c, p) > 1 && a.vbuf == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_k4_mode<FULL>(a, p, static_cast<cudaStream_t>(stream));
}

}  // namespace
