// Hand-written Hopper (sm_90a) probe kernel: a depthwise 7x7 convolution
// with its per-pixel moments, with a plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/dw_moments.py). No PyTorch headers.
//
// M3  gcv_dw_moments  replaces the Pallas kernel `kernel` of
//     tools/microbench_dwshift.py (entry shift7_fn; pallas_call at :108).
//     Per pixel of an NHWC bf16 activation x [N, H, W, C], with f32 weights
//     k [7, 7, C] and bias b [C] (:93-103):
//
//       acc  = b + sum over (dy, dx) of x[y+dy-3, x+dx-3] * k[dy, dx]   f32, zero halo
//       dw   = bf16(acc)
//       mean = sum_c(acc) / C,  var = sum_c(acc^2) / C - mean^2          of the f32 acc
//
//     The moments come from the f32 sum before its bf16 rounding, as the
//     Pallas kernel takes them (not from the rounded dw, as the tool's
//     xla_fn and the port's Block.forward_folded do). This is the first
//     half of the LN-folded block (models/convnext.py, forward_folded).
//     Each tap is one fused multiply-add from the bias, dy outer and dx
//     inner, as the plain version sums them: a bf16 x f32 product is not
//     exact in f32, so against its multiply then add a tap may differ by an
//     f32 ulp; with bf16-representable weights (the tests and chip_smoke.py)
//     the two agree bit for bit, but for the sign of a zero.
//
//     What bounds it on the card: at the LN-folded block shapes the bytes
//     (x in and dw out once, 4 bytes a channel of a pixel, and 8 bytes of
//     moments a pixel), with the f32 taps close behind; at the JAX tool's
//     56 x 56 the taps, 2 f32 operations each at 67 TFLOP/s. Only the taps
//     whose input lies inside the image are work: a tap in the zero halo
//     adds nothing, and this kernel does not run it. What holds it today is
//     the load/store pipe, not the f32 units: each output row of a task
//     costs 13 two-byte window reads, 49 weight reads, 7 two-byte dw stores
//     and the moments' scratch round trip beside its up to 343 taps
//     (PERF.md section 6).
//
//     What the design does. A work item is an image, or a band of its rows
//     (and of its columns past 56), with all C channels, walked in slices of
//     g groups of 32 channels. Persistent blocks of 16 warps, one per SM,
//     walk the items in a fixed order. Each slice's stage, its x tile
//     [rows][cols][32 g] bf16 and its weights [49][32 g] and bias [32 g]
//     f32, comes into a ring of shared-memory stages: by TMA (4-D, 2-D and
//     1-D maps; the x box starts 3 rows (and columns) before a band, so that
//     the hardware fills what lies outside the image with zeros) issued by
//     one thread as soon as all warps are done with the stage, or, where
//     C % 8 != 0 (no TMA map), by every thread's copies. Whole images carry
//     no halo: no tap reads it. A slice's tasks are one group's output tile
//     of up to 7 rows and 7 columns (a lane a channel: 64 contiguous bytes
//     of a pixel, no bank conflicts); the warps take them in turn. A task
//     reads each input row inside the image that its tile needs once, into
//     a window of 13 pixels in registers, and adds it to each of its output
//     rows that takes it, with that row's 7 weights of the dy it needs read
//     from the stage; its 49 f32 sums stay in registers. Each sum runs from
//     the bias, dy outer and dx inner. The rows outside the image are never
//     visited; the columns outside the image are fixed at compile time for
//     the run shapes that widths divisible by 7 give (first, last, both,
//     interior), and bounded at run time, uniformly over the warp, for the
//     others. A finished row's 7 pixels go out as bf16, and its moments meet
//     through the warp's scratch (emit_row), then in the item's per-group
//     partials in shared memory, summed over the slices in order. At the
//     item's end the threads sum the groups' partials in order and write
//     mean and var: no atomics, so two launches give the same bits. m3_plan
//     (mirrored in ops/cuda/dw_moments.py) picks the rows of an item and of
//     a task, the slice width and the stages.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstring>

#include "wgmma.cuh"   // mbarriers, TMA, encode_tiled, sm_count, raise_smem_limit

namespace {

constexpr int kRun = 7;                  // output columns of a task
constexpr int kWin = kRun + 6;           // the input columns they read
constexpr int kWarps = 16;               // a block's warps, all of them compute
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroups = 8;            // groups of 32 channels a slice: a TMA box of 256
constexpr int kBandCols = 8 * kRun;      // columns of an item at most
constexpr int kSmemMax = 232448;
constexpr int kRedStride = 36;           // floats a pixel of a warp's scratch: 16-byte rows
constexpr int kRedBytes = kRun * kRedStride * 4;         // an output row's f32 sums
constexpr int kSmemFixed = 1024 + kWarps * kRedBytes;   // mbarriers, alignment, scratch
constexpr int kMaxStages = 4;

// M3's plan at (h, w, c). An item is bh rows x bw columns of one image,
// with all channels, walked in slices of g groups of 32 channels; a slice's
// tile is tr x tc pixels (bands carry a 3-pixel halo). A task is one
// group's output tile of th rows (of nt a band) and kRun columns (of nr a
// row); the 16 warps take a slice's g * nr * nt tasks in turn. stages 0:
// M3 does not take the shape.
struct M3Plan {
  int bh, bw, th, nt, nr, g, tr, tc, stages, smem, tma;
};

// A stage: the slice's x tile [tr][tc][32 g] bf16, then its weights
// [49][32 g] and bias [32 g] f32.
__host__ __device__ constexpr int m3_tile_bytes(int tr, int tc, int g) {
  return (tr * tc * 64 * g + 127) / 128 * 128;
}

__host__ __device__ constexpr int m3_stage_bytes(int tr, int tc, int g) {
  return m3_tile_bytes(tr, tc, g) + 50 * 128 * g;
}

// The rows of a task and the slice width for an item of bh rows: as many
// row tiles (of at most 7 rows) as make 16 tasks a slice, then the groups
// that fill the warps, spread evenly over the fewest slices.
__host__ inline void m3_tasks(int bh, int nr, int ng, M3Plan* p) {
  const int cap = ng < kMaxGroups ? ng : kMaxGroups;
  p->nt = (bh + 6) / 7;
  while (p->nt < bh && nr * p->nt * cap < kWarps) ++p->nt;
  p->th = (bh + p->nt - 1) / p->nt;
  p->nt = (bh + p->th - 1) / p->th;
  int g = kWarps / (nr * p->nt);
  g = g < 1 ? 1 : g > cap ? cap : g;
  const int slices = (ng + g - 1) / g;
  p->g = (ng + slices - 1) / slices;
}

__host__ inline int m3_smem(const M3Plan& p, int stages) {
  return kSmemFixed + 2 * p.g * p.bh * p.bw * 8 + stages * m3_stage_bytes(p.tr, p.tc, p.g);
}

__host__ inline M3Plan m3_plan(int h, int w, int c) {
  M3Plan p = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (h <= 0 || w <= 0 || c <= 0 || c % 2 != 0) return p;
  const int ng = (c + 31) / 32;
  p.bw = w < kBandCols ? w : kBandCols;
  p.tc = p.bw + (p.bw < w ? 6 : 0);
  p.nr = (p.bw + kRun - 1) / kRun;
  // the whole image if two stages fit, else equal bands of rows (a multiple
  // of 7 where that fits) with a 3-row halo
  p.bh = p.tr = h;
  m3_tasks(h, p.nr, ng, &p);
  if (h > 250 || m3_smem(p, 2) > kSmemMax) {
    int bh = h - 1 < 250 ? h - 1 : 250;
    for (; bh > 0; --bh) {
      if (bh > 7 && bh % 7 != 0) continue;
      p.bh = bh;
      p.tr = bh + 6;
      m3_tasks(bh, p.nr, ng, &p);
      if (m3_smem(p, 2) <= kSmemMax) break;
    }
    if (bh == 0) return M3Plan{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    const int bands = (h + bh - 1) / bh;
    p.bh = (h + bands - 1) / bands;
    p.tr = p.bh + 6;
    m3_tasks(p.bh, p.nr, ng, &p);
    if (m3_smem(p, 2) > kSmemMax) {   // the equal bands take more groups: keep bh
      p.bh = bh;
      p.tr = bh + 6;
      m3_tasks(bh, p.nr, ng, &p);
    }
  }
  p.stages = (kSmemMax - m3_smem(p, 0)) / m3_stage_bytes(p.tr, p.tc, p.g);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.smem = m3_smem(p, p.stages);
  p.tma = c % 8 == 0;
  return p;
}

struct M3Args {
  const bf16* x;
  const float* k;
  const float* b;
  bf16* dw;
  float* mu;
  float* var;
  int n, h, w, c;
  int nbh, nbw, slices, ng;
  long long items;
};

// TMA: the box of a 1-D tensor map at c0, completing `bar`'s transactions;
// elements outside the tensor read as zero.
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, int c0,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2}], [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(smem_u32(bar))
      : "memory");
}

// TMA: the box of a 4-D tensor map at (c0, c1, c2, c3), innermost first,
// completing `bar`'s transactions; elements outside the tensor read as zero.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// What a warp's task needs: one group's output tile of a slice.
struct Task {
  const bf16* tile;     // the stage's x tile, at this lane's channel
  const float* w;       // the stage's weights, at this lane's channel
  int wstride;          // floats between weight rows (32 g)
  int row_stride;       // elements between tile rows
  int pix;              // elements between tile columns (32 g)
  int ty0, tx0;         // image row and column of the tile's origin
  int y0, y1, h;        // the task's output rows [y0, y1); image rows
  int yb, x0, xb, bw;   // the item's first row; the task's first column; the item's; its width
  bf16* dw;             // dw at (n, 0, x0, channel), or null (channel past C)
  long long dw_row;     // elements between image rows of dw
  int c;
  float* red;           // the warp's scratch [kRun][kRedStride]
  float* mom;           // the item's partials of this group [bh * bw][2]
  bool first;           // the item's first slice: partials stored, not added
};

// A finished output row y of the task: dw out, then its moments. The
// pixels' f32 sums go to the warp's scratch; lanes 4p..4p+3 each add 8 of
// pixel p's 32 channels (two 16-byte reads) and their squares, in a fixed
// order, and meet by two shuffles; the first adds the pixel's sum and sum
// of squares to the group's partials.
__device__ __forceinline__ void emit_row(const Task& q, const float (&a)[kRun], int y, int v,
                                         int lane) {
  if (q.dw != nullptr) {
    bf16* d = q.dw + static_cast<long long>(y) * q.dw_row;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (i < v) d[static_cast<long long>(i) * q.c] = __float2bfloat16_rn(a[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) q.red[i * kRedStride + lane] = a[i];
  __syncwarp();
  const int p = lane >> 2 < kRun ? lane >> 2 : kRun - 1;
  const float4* src = reinterpret_cast<const float4*>(q.red + p * kRedStride + 8 * (lane & 3));
  const float4 u0 = src[0], u1 = src[1];
  const float e[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
  float s = e[0], sq = __fmul_rn(e[0], e[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    s = __fadd_rn(s, e[i]);
    sq = __fmaf_rn(e[i], e[i], sq);
  }
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 1));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
  sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 2));
  if ((lane & 3) == 0 && (lane >> 2) < v) {
    float2* m = reinterpret_cast<float2*>(q.mom) + (y - q.yb) * q.bw + (q.x0 - q.xb) + (lane >> 2);
    if (q.first) {
      *m = make_float2(s, sq);
    } else {
      const float2 o = *m;
      *m = make_float2(__fadd_rn(o.x, s), __fadd_rn(o.y, sq));
    }
  }
  __syncwarp();
}

// One task: the output rows [y0, y1) (at most 7, slot t the row y0 + t) of
// kRun columns from x0. Every input row inside the image that they read is
// read once into a window of kWin pixels, and each slot takes its weight
// row dy (from the stage) and its taps, dx in order: from the bias, dy
// outer and dx inner, as the plain version sums. kL (kR): window columns on
// the left (right) that lie outside the image, fixed for the run shapes of
// widths divisible by 7 (then v == kRun); kGen: l, r and the valid outputs
// v at run time instead.
template <int kL, int kR, bool kGen>
__device__ __forceinline__ void task(const Task& q, int l, int r_out, int v, int lane) {
  constexpr int jlo = kGen ? 0 : kL;
  constexpr int jhi = kGen ? kWin : kWin - kR;
  const float bias = q.w[49 * q.wstride];
  float acc[7][kRun];
#pragma unroll
  for (int t = 0; t < 7; ++t) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[t][i] = bias;
  }
  const int rlo = q.y0 - 3 > 0 ? q.y0 - 3 : 0;
  const int rhi = q.y1 + 3 < q.h ? q.y1 + 3 : q.h;
  for (int r = rlo; r < rhi; ++r) {
    const bf16* row = q.tile + (r - q.ty0) * q.row_stride + (q.x0 - 3 - q.tx0) * q.pix;
    float win[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      win[j] = 0.f;
      if (j < jlo || j >= jhi || (kGen && (j < l || j >= kWin - r_out))) continue;
      win[j] = __bfloat162float(row[j * q.pix]);
    }
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      const int dy = r - q.y0 - t + 3;
      if (dy < 0 || dy > 6 || q.y0 + t >= q.y1) continue;
      const float* wr = q.w + dy * 7 * q.wstride;
      float wd[7];
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) wd[dx] = wr[dx * q.wstride];
#pragma unroll
      for (int j = jlo; j < jhi; ++j) {
        if (kGen && (j < l || j >= kWin - r_out)) continue;
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const int dx = j - i;
          if (dx < 0 || dx > 6 || (kGen && i >= v)) continue;
          acc[t][i] = fmaf(win[j], wd[dx], acc[t][i]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 7; ++t) {
    if (q.y0 + t < q.y1) emit_row(q, acc[t], q.y0 + t, kGen ? v : kRun, lane);
  }
}

template <bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
dw_moments_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap bmap, const M3Args a, const M3Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const int stage_bytes = m3_stage_bytes(p.tr, p.tc, p.g);
  const int tile_bytes = m3_tile_bytes(p.tr, p.tc, p.g);
  float* mom = reinterpret_cast<float*>(ring + p.stages * stage_bytes);
  const int pixels = p.bh * p.bw;
  const int mom_item = p.g * pixels * 2;   // floats of one item's partials
  float* red = mom + 2 * mom_item;
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kWarps * (kRedBytes / 4));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hr = p.bh < a.h ? 3 : 0, hc = p.bw < a.w ? 3 : 0;
  const int gc = 32 * p.g;   // channels of a slice
  const long long my_items = (a.items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long fills = my_items * a.slices;

  // fill f of this block: slice f % slices of its item f / slices, into
  // stage f % stages; thread 0 issues it by TMA, or every thread copies
  auto fill = [&](long long f) {
    const long long item = blockIdx.x + (f / a.slices) * gridDim.x;
    const int s = static_cast<int>(f % a.slices);
    const int bx = static_cast<int>(item % a.nbw);
    const long long rest = item / a.nbw;
    const int by = static_cast<int>(rest % a.nbh), n = static_cast<int>(rest / a.nbh);
    const int ty0 = by * p.bh - hr, tx0 = bx * p.bw - hc;
    const int st = static_cast<int>(f % p.stages);
    unsigned char* dst = ring + st * stage_bytes;
    if constexpr (kTma) {
      mbar_expect_tx(&full[st], static_cast<uint32_t>(p.tr * p.tc * 2 * gc + 50 * 4 * gc));
      tma_load_4d(dst, &xmap, s * gc, tx0, ty0, n, &full[st]);
      tma_load_2d(dst + tile_bytes, &kmap, s * gc, 0, &full[st]);
      tma_load_1d(dst + tile_bytes + 49 * 4 * gc, &bmap, s * gc, &full[st]);
    } else {
      bf16* t = reinterpret_cast<bf16*>(dst);
      for (int e = threadIdx.x; e < p.tr * p.tc * gc; e += kThreads) {
        const int ch = s * gc + e % gc, col = tx0 + (e / gc) % p.tc, row = ty0 + e / gc / p.tc;
        bf16 v = __float2bfloat16_rn(0.f);
        if (ch < a.c && col >= 0 && col < a.w && row >= 0 && row < a.h) {
          v = a.x[((static_cast<long long>(n) * a.h + row) * a.w + col) * a.c + ch];
        }
        t[e] = v;
      }
      float* wb = reinterpret_cast<float*>(dst + tile_bytes);
      for (int e = threadIdx.x; e < 50 * gc; e += kThreads) {
        const int ch = s * gc + e % gc, row = e / gc;
        wb[e] = ch >= a.c ? 0.f : row < 49 ? a.k[static_cast<long long>(row) * a.c + ch] : a.b[ch];
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&full[s], 1);
  }
  __syncthreads();
  const long long ahead = fills < p.stages ? fills : p.stages;
  if (!kTma || threadIdx.x == 0) {
    for (long long f = 0; f < ahead; ++f) fill(f);
  }
  __syncthreads();

  const float inv_c = 1.0f / static_cast<float>(a.c);
  const int tasks_per_group = p.nr * p.nt;
  float* warp_red = red + warp * (kRedBytes / 4);
  for (long long f = 0; f < fills; ++f) {
    const long long local = f / a.slices;
    const long long item = blockIdx.x + local * gridDim.x;
    const int s = static_cast<int>(f % a.slices);
    const int bx = static_cast<int>(item % a.nbw);
    const long long rest = item / a.nbw;
    const int by = static_cast<int>(rest % a.nbh), n = static_cast<int>(rest / a.nbh);
    const int yb = by * p.bh, xb = bx * p.bw;
    const int yend = yb + p.bh < a.h ? yb + p.bh : a.h;
    float* item_mom = mom + (local & 1) * mom_item;
    const int st = static_cast<int>(f % p.stages);
    if constexpr (kTma) mbar_wait(&full[st], static_cast<uint32_t>((f / p.stages) & 1));
    unsigned char* stage = ring + st * stage_bytes;
    for (int tk = warp; tk < p.g * tasks_per_group; tk += kWarps) {
      const int g = tk / tasks_per_group, rho = tk % p.nr, tau = tk % tasks_per_group / p.nr;
      const int grp = s * p.g + g;
      const int x0 = xb + kRun * rho, y0 = yb + tau * p.th;
      if (grp >= a.ng || x0 >= a.w || x0 >= xb + p.bw || y0 >= yend) continue;
      const int ch = grp * 32 + lane;
      Task q;
      q.tile = reinterpret_cast<const bf16*>(stage) + g * 32 + lane;
      q.w = reinterpret_cast<const float*>(stage + tile_bytes) + g * 32 + lane;
      q.wstride = gc;
      q.pix = gc;
      q.row_stride = p.tc * gc;
      q.ty0 = yb - hr;
      q.tx0 = xb - hc;
      q.y0 = y0;
      q.y1 = y0 + p.th < yend ? y0 + p.th : yend;
      q.h = a.h;
      q.yb = yb;
      q.x0 = x0;
      q.xb = xb;
      q.bw = p.bw;
      q.dw_row = static_cast<long long>(a.w) * a.c;
      q.dw = ch < a.c ? a.dw + (static_cast<long long>(n) * a.h * a.w + x0) * a.c + ch : nullptr;
      q.c = a.c;
      q.red = warp_red;
      q.mom = item_mom + g * pixels * 2;
      q.first = s == 0;
      const int v = a.w - x0 < kRun ? a.w - x0 : kRun;
      const int l = x0 < 3 ? 3 - x0 : 0;
      const int r_out = x0 + kRun + 3 - a.w > 0 ? x0 + kRun + 3 - a.w : 0;
      if (v == kRun && (r_out == 0 || r_out == 3)) {
        if (l == 0 && r_out == 0) task<0, 0, false>(q, l, r_out, v, lane);
        else if (l == 0) task<0, 3, false>(q, l, r_out, v, lane);
        else if (r_out == 0) task<3, 0, false>(q, l, r_out, v, lane);
        else task<3, 3, false>(q, l, r_out, v, lane);
      } else {
        task<0, 0, true>(q, l, r_out, v, lane);
      }
    }
    // every warp is done with the stage (and the slice's partials are in)
    bar_sync(1, kThreads);
    if (f + p.stages < fills && (!kTma || threadIdx.x == 0)) fill(f + p.stages);
    if (s + 1 == a.slices) {
      // the item's moments: its groups' partials summed in order
      for (int px = static_cast<int>(threadIdx.x); px < pixels; px += kThreads) {
        const int y = yb + px / p.bw, xx = xb + px % p.bw;
        if (y >= a.h || xx >= a.w) continue;
        float sum = item_mom[2 * px], sq = item_mom[2 * px + 1];
        for (int gg = 1; gg < p.g; ++gg) {
          sum = __fadd_rn(sum, item_mom[(gg * pixels + px) * 2]);
          sq = __fadd_rn(sq, item_mom[(gg * pixels + px) * 2 + 1]);
        }
        const long long o = (static_cast<long long>(n) * a.h + y) * a.w + xx;
        const float mean = __fmul_rn(sum, inv_c);
        a.mu[o] = mean;
        a.var[o] = __fsub_rn(__fmul_rn(sq, inv_c), __fmul_rn(mean, mean));
      }
    }
  }
}

// A tensor map of `rank` dimensions (innermost first) over `base`, in
// boxes of `box`, no swizzle, zero outside the tensor.
__host__ inline int tile_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                             const void* base, const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The slice's maps: x [n, h, w, c] bf16 in boxes of [32 g channels, tc
// columns, tr rows, 1 image]; k as [49, c] f32 in boxes of [32 g, 49]; b
// [c] f32 in boxes of 32 g.
__host__ inline int slice_maps(CUtensorMap* maps, const M3Args& a, const M3Plan& p) {
  const cuuint64_t c = static_cast<cuuint64_t>(a.c);
  const cuuint32_t gc = static_cast<cuuint32_t>(32 * p.g);
  const cuuint64_t xdims[4] = {c, static_cast<cuuint64_t>(a.w), static_cast<cuuint64_t>(a.h),
                               static_cast<cuuint64_t>(a.n)};
  const cuuint64_t xstrides[3] = {c * 2, c * 2 * a.w, c * 2 * a.w * a.h};
  const cuuint32_t xbox[4] = {gc, static_cast<cuuint32_t>(p.tc), static_cast<cuuint32_t>(p.tr), 1};
  int r = tile_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.x, xdims, xstrides, xbox);
  const cuuint64_t kdims[2] = {c, 49};
  const cuuint64_t kstrides[1] = {c * 4};
  const cuuint32_t kbox[2] = {gc, 49};
  if (r == 0) r = tile_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.k, kdims, kstrides, kbox);
  if (r == 0) r = tile_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, a.b, &c, kstrides, &gc);
  return r;
}

template <bool kTma>
int launch_dw(const M3Args& a, const M3Plan& p, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const int err = raise_smem_limit(dw_moments_kernel<kTma>, static_cast<size_t>(p.smem),
                                   &smem_configured);
  if (err) return err;
  CUtensorMap maps[3];
  if constexpr (kTma) {
    const int r = slice_maps(maps, a, p);
    if (r) return r;
  } else {
    memset(maps, 0, sizeof(maps));
  }
  const long long blocks = a.items < sm_count() ? a.items : sm_count();
  dw_moments_kernel<kTma><<<static_cast<unsigned int>(blocks), kThreads, p.smem, stream>>>(
      maps[0], maps[1], maps[2], a, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// M3's plan at (h, w, c): out = {bh, bw, th, nt, nr, g, tr, tc, stages,
// smem, tma} (M3Plan); returns 0 where M3 does not take the shape.
int gcv_m3_plan(int h, int w, int c, int* out) {
  const M3Plan p = m3_plan(h, w, c);
  const int v[11] = {p.bh, p.bw, p.th, p.nt, p.nr, p.g, p.tr, p.tc, p.stages, p.smem, p.tma};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return p.stages != 0;
}

// M3. x, dw [n, h, w, c] bf16 NHWC; k [7, 7, c] and b [c] f32; mu, var
// [n, h, w] f32; c even, every tensor 16-byte aligned (the caller checks).
int gcv_dw_moments(const void* x, const void* k, const void* b, void* dw, void* mu, void* var,
                   int n, int h, int w, int c, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  const M3Plan p = m3_plan(h, w, c);
  if (p.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  M3Args a;
  a.x = static_cast<const bf16*>(x);
  a.k = static_cast<const float*>(k);
  a.b = static_cast<const float*>(b);
  a.dw = static_cast<bf16*>(dw);
  a.mu = static_cast<float*>(mu);
  a.var = static_cast<float*>(var);
  a.n = n;
  a.h = h;
  a.w = w;
  a.c = c;
  a.nbh = (h + p.bh - 1) / p.bh;
  a.nbw = (w + p.bw - 1) / p.bw;
  a.ng = (c + 31) / 32;
  a.slices = (a.ng + p.g - 1) / p.g;
  a.items = static_cast<long long>(n) * a.nbh * a.nbw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.tma ? launch_dw<true>(a, p, s) : launch_dw<false>(a, p, s);
}

}  // extern "C"
