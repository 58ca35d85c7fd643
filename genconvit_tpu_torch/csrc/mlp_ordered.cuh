// K1's ordered route: the ConvNeXt block tail as one persistent launch of
// ordered work items, for the widths where K1's fused loop (mlp_wgmma.cuh)
// would compute fc1 more than once (more than one pass over the hidden
// dimension: C from 224 up; C = 384, 768 and 1536 in convnext_tiny and
// _large, 1024 in _base) and no post-LN is asked for. The wrapper
// (convnext_mlp.k1_route) routes those calls here through convnext_mlp.cu;
// every other K1 call keeps the fused kernel.
//
// It replaces, as the fused kernel does, the Pallas kernel _mlp_kernel of
// genconvit_tpu/ops/pallas/convnext_mlp.py:74, with the same arithmetic and
// rounding points:
//   y   = bf16((d - mean) * rstd)   f32 row statistics, E[d^2] - mean^2
//   h   = bf16(GELU(y . wg + bw))   f32 sums, rational erf at the plan's tier
//   out = x + bf16(h . w2g + b2g)   f32 sums, then the bf16 add
//
// What bounds it. Per row, 16 C^2 operations against 6 C bytes of d, x and
// out: at every routed width the tensor cores bound it on this card (989
// TFLOP/s bf16 against 3.35 TB/s), 0.1122 ms for a convnext_tiny C = 384 or
// 768 launch at the ED call's rows, 0.4489 ms for convnext_large's C = 768
// and 1536. The fused loop keeps the [rows, 4C] hidden in registers, which
// leaves room for only C / 2 fc2 sums a thread: from C = 224 it splits the
// output columns into groups and computes fc1 again for each (24 R C^2
// operations at C = 384, 40 at 768, 104 at 1536, where 16 are needed) and
// streams all of w1t from L2 for every pass of every row tile. Below
// C = 224 one pass serves: there the hidden stays in registers and never
// leaves the SM, which is cheaper than any round trip.
//
// What this loop does instead: the hidden goes through a [rows, 4C] bf16
// scratch, written once and read back by TMA. Three kinds of work item per
// 128-row block m:
//   LN(m)      row statistics and y into a [rows, C] bf16 scratch
//   fc1(m, n)  y_m . w1t tile n (128 hidden columns), bias and GELU in
//              registers, bf16 into the hidden scratch
//   fc2(m, n)  h_m . w2t tile n (128 output columns, K = 4C), bf16(o + b2g)
//              and the bf16 add of x into out
// They are numbered in phase order: every LN, then every fc1 (by row block,
// then tile), then every fc2, so each depends only on lower-numbered ones,
// and a row block's tiles follow each other: y_m is read from device memory
// once and from L2 by the other fc1 tiles of m, h_m likewise by the fc2
// tiles. (An order that interleaves the phases, fc2(m) a few waves of the
// grid after fc1(m) so that h_m would go through L2 alone, measured 4-23%
// slower at every routed width: its producers wait on dependencies, which
// stalls both consumer warpgroups, and the phases' operands crowd each
// other out of L2.) Persistent blocks, at most one per SM, take items in
// that order from a ticket counter; a block's producer thread waits on the
// row block's readiness word with acquire loads before it loads an item's
// operands, and the items it waits for publish with a release once every
// thread that stored has stored. The ticket order makes a deadlock
// impossible: an item is taken only by a running block, and all it waits
// for was taken earlier. The readiness flags are one word for each LN item
// and one for each fc1 tile, which its item sets to the launch's generation:
// the wrapper passes a new generation each launch, so nothing is cleared
// between calls (and a flag is only ever written, never counted up, so no
// update can be lost to another), and the last block to finish sets the
// ticket counter back to zero for the next launch. No memset, no helper
// kernel: one launch per call.
//
// A block is two consumer warpgroups and a producer warpgroup, one thread
// of which draws the tickets, hands the items to the consumers through a
// queue in shared memory, alternately to each warpgroup, and streams their
// operands by TMA (128-byte swizzled 64-k boxes of 128 rows: y or h, and w1t
// or w2t; zero past the edges) into a ring of seven 32 KB stages. The ring
// has twice as many full barriers as stages (fill q completes barrier
// q % 14): a warpgroup's first stages of an item were last filled for the
// other warpgroup, and that fill may still be in flight when it starts to
// wait; with one barrier a stage, that barrier would be two phases behind,
// at the parity the wait expects, and the wait would pass at once. With 14,
// the fill before q on q's barrier is q - 14, which landed before fill
// q - 7 could be issued, so the barrier is at most one phase behind. Each
// warpgroup computes its own items, 128 x 128 tiles as two m64n128k16
// products a k step with both operands in shared memory, one k-block in
// flight while the next one's stage is awaited: while one warpgroup runs
// its epilogue (the GELU, ~25 f32 operations a hidden value, about half of
// fc1's tensor time at C = 768), the other's products keep the tensor cores
// busy. The tile's biases are staged in shared memory while the products
// run, and fc2 asks L2 for its x rows before its products. The scratch
// buffers and the readiness words come from the wrapper.
#pragma once

#include "wgmma.cuh"

namespace {

constexpr int kOrdThreads = 384;
constexpr int kOrdRows = 128;         // rows of a row block, and of a tile
constexpr int kOrdCols = 128;         // columns of a tile (fc1: hidden, fc2: output)
constexpr int kOrdStages = 7;
constexpr int kOrdFull = 2 * kOrdStages;   // full barriers: fill q completes q % kOrdFull
constexpr int kOrdABytes = kOrdRows * 128;               // 128 rows x 64 k of y or h
constexpr int kOrdStageBytes = kOrdABytes + kOrdCols * 128;   // + 128 weight rows
constexpr int kOrdQueue = 4;          // two entries a warpgroup
constexpr int kOrdBars = 512;        // the queue and the barriers
constexpr int kOrdSmem = 1024 + kOrdStages * kOrdStageBytes + kOrdBars + 2 * kOrdCols * 4;
static_assert(kOrdSmem <= 227 * 1024, "past the shared memory a block may have");

struct OrdArgs {
  const bf16* d;
  const bf16* x;
  const float* bw;     // [4C]
  const float* b2g;    // [C]
  bf16* y;             // [rows, C] scratch
  bf16* h;             // [rows, 4C] scratch
  bf16* out;
  unsigned long long* flags;   // [0] tickets, [1] blocks done, then per row block m (from
                               // 2 + m (1 + n1)) its LN's flag and its n1 fc1 tiles'
  long long rows;
  int c;
  int mblocks;         // row blocks of 128
  int n1, n2;          // fc1 and fc2 tiles a row block
  int nk1, nk2;        // 64-k blocks of fc1 (C) and fc2 (4C)
  float eps;           // the LayerNorm's
  unsigned long long gen;   // this launch's generation (never 0)
  int plant;           // planted faults (launch_ordered): 1 the readiness waits
                       // skipped, 2 each row block's items in a row
};

// An item: kind 0 LN, 1 fc1, 2 fc2, -1 no more; m its row block, n its tile.
struct OrdItem {
  int kind, m, n;
};

__host__ __device__ inline long long ord_total(const OrdArgs& a) {
  return static_cast<long long>(a.mblocks) * (1 + a.n1 + a.n2);
}

// ticket t (below ord_total) -> its item, in phase order (or row order)
__device__ __forceinline__ OrdItem ord_item(const OrdArgs& a, long long t) {
  if (a.plant & 2) {
    const int per_row = 1 + a.n1 + a.n2;
    const int m = static_cast<int>(t / per_row);
    const int off = static_cast<int>(t % per_row);
    if (off == 0) return OrdItem{0, m, 0};
    return off <= a.n1 ? OrdItem{1, m, off - 1} : OrdItem{2, m, off - 1 - a.n1};
  }
  if (t < a.mblocks) return OrdItem{0, static_cast<int>(t), 0};
  t -= a.mblocks;
  if (t < static_cast<long long>(a.mblocks) * a.n1) {
    return OrdItem{1, static_cast<int>(t / a.n1), static_cast<int>(t % a.n1)};
  }
  t -= static_cast<long long>(a.mblocks) * a.n1;
  return OrdItem{2, static_cast<int>(t / a.n2), static_cast<int>(t % a.n2)};
}

__device__ __forceinline__ unsigned long long ld_relaxed_u64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Row block m's flags: [0] its LN, [1 + n] its fc1 tile n.
__device__ __forceinline__ unsigned long long* ord_flags(const OrdArgs& a, int m) {
  return a.flags + 2 + static_cast<long long>(m) * (1 + a.n1);
}

__device__ __forceinline__ void st_release_u64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}


// generic-proxy global writes ordered with TMA (async-proxy) reads
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Whether the n flags from p all hold gen: relaxed loads, in flight together.
__device__ __forceinline__ bool ord_ready(const unsigned long long* p, int n,
                                          unsigned long long gen) {
  bool ready = true;
  for (int i = 0; i < n; ++i) ready &= ld_relaxed_u64(p + i) == gen;
  return ready;
}

// Spin until the n flags from p hold gen, then acquire what their writers
// released; more than 2^35 clocks (about 20 s) traps, so that a lost
// release ends the launch with an error.
__device__ __forceinline__ void ord_wait(const unsigned long long* p, int n,
                                         unsigned long long gen) {
  if (!ord_ready(p, n, gen)) {
    const long long t0 = clock64();
    while (!ord_ready(p, n, gen)) {
      __nanosleep(64);
      if (clock64() - t0 > (1ll << 35)) __trap();
    }
  }
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]: A and B by descriptor.
__device__ __forceinline__ void ord_wgmma_ss_n128(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

struct OrdSmem {
  unsigned char* ring;
  int4* queue;         // [kOrdQueue]: (kind, m, n, the item's first stage)
  uint64_t* full;      // [kOrdFull]: the producer's arrival with the bytes
  uint64_t* empty;     // [kOrdStages]: lane 0 of each warp of the stage's warpgroup
  uint64_t* qfull;     // [kOrdQueue]: the producer's arrival
  uint64_t* qempty;    // [kOrdQueue]: every thread of the entry's warpgroup
  float* bias;         // [2 warpgroups][kOrdCols]

  __device__ __forceinline__ explicit OrdSmem(unsigned char* base) {
    ring = base;
    queue = reinterpret_cast<int4*>(base + kOrdStages * kOrdStageBytes);
    full = reinterpret_cast<uint64_t*>(queue + kOrdQueue);
    empty = full + kOrdFull;
    qfull = empty + kOrdStages;
    qempty = qfull + kOrdQueue;
    bias = reinterpret_cast<float*>(base + kOrdStages * kOrdStageBytes + kOrdBars);
  }
};
static_assert(kOrdQueue * 16 + (kOrdFull + kOrdStages + 2 * kOrdQueue) * 8 <= kOrdBars,
              "the queue and the barriers overrun their region");

// The producer thread: draw tickets until they run out, hand each item to
// its warpgroup (entry qi to warpgroup qi % 2), wait for what it reads,
// stream its operands.
__device__ __forceinline__ void ord_produce(const OrdArgs& a, const OrdSmem& s,
                                            const CUtensorMap* ty, const CUtensorMap* tw1,
                                            const CUtensorMap* th, const CUtensorMap* tw2) {
  const long long total = ord_total(a);
  uint32_t q = 0;
  for (int qi = 0, stops = 0; stops < 2; ++qi) {
    const long long t = stops ? total : static_cast<long long>(atomicAdd(a.flags, 1ull));
    const OrdItem it = t < total ? ord_item(a, t) : OrdItem{-1, 0, 0};
    stops += it.kind < 0;   // one stop for each warpgroup
    const int slot = qi % kOrdQueue;
    mbar_wait(&s.qempty[slot], ((qi / kOrdQueue) & 1) ^ 1);
    s.queue[slot] = make_int4(it.kind, it.m, it.n, static_cast<int>(q));
    mbar_arrive(&s.qfull[slot]);
    if (it.kind <= 0) continue;
    const bool fc1 = it.kind == 1;
    // fc1 reads LN(m)'s y, fc2 every fc1 tile's h of m
    if (!(a.plant & 1)) ord_wait(ord_flags(a, it.m) + (fc1 ? 0 : 1), fc1 ? 1 : a.n1, a.gen);
    fence_proxy_async_global();
    const CUtensorMap* ta = fc1 ? ty : th;
    const CUtensorMap* tb = fc1 ? tw1 : tw2;
    const int nk = fc1 ? a.nk1 : a.nk2;
    for (int kb = 0; kb < nk; ++kb, ++q) {
      const int st = q % kOrdStages;
      mbar_wait(&s.empty[st], ((q / kOrdStages) & 1) ^ 1);
      unsigned char* dst = s.ring + st * kOrdStageBytes;
      uint64_t* full = &s.full[q % kOrdFull];
      mbar_expect_tx(full, kOrdStageBytes);
      tma_load_2d(dst, ta, 64 * kb, kOrdRows * it.m, full);
      tma_load_2d(dst + kOrdABytes, tb, 64 * kb, kOrdCols * it.n, full);
    }
  }
  // every block has drawn its last ticket once the count reaches the grid:
  // the last one sets the counters back for the next launch
  if (atomicAdd(a.flags + 1, 1ull) == gridDim.x - 1) {
    a.flags[0] = 0;
    a.flags[1] = 0;
  }
}

// One item's products for a consumer warpgroup: acc[0..63] = rows 0-63 of
// the tile, acc[64..127] = rows 64-127, over nk k-blocks from stage q on,
// one k-block's products in flight while the next stage is awaited.
__device__ __forceinline__ void ord_mainloop(float* acc, const OrdSmem& s, int nk, uint32_t q) {
  // zeroed here, so that nothing of the last item's sums stays live
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  for (int kb = 0; kb < nk; ++kb, ++q) {
    const int st = q % kOrdStages;
    mbar_wait(&s.full[q % kOrdFull], (q / kOrdFull) & 1);
    wgmma_fence();
    unsigned char* base = s.ring + st * kOrdStageBytes;
    const uint64_t da = sw128_desc(base);
    const uint64_t db = sw128_desc(base + kOrdABytes);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ord_wgmma_ss_n128(acc, da + 2 * k, db + 2 * k, 1);
      ord_wgmma_ss_n128(acc + 64, da + 512 + 2 * k, db + 2 * k, 1);   // rows 64.. (+8192 bytes)
    }
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();
      if (threadIdx.x % 32 == 0) mbar_arrive(&s.empty[(q - 1) % kOrdStages]);
    }
  }
  wgmma_wait<0>();
  fence_regs<128>(acc);
  if (threadIdx.x % 32 == 0) mbar_arrive(&s.empty[(q - 1) % kOrdStages]);
}

// LN(m) for a warp's rows [r0, r0 + nrows): the statistics and rounding of
// ln_rows_to_y (convnext_mlp.cu), y stored row-major; RB rows at a time,
// whose loads are in flight together.
template <int RB>
__device__ __forceinline__ void ord_ln_rows(const OrdArgs& a, long long r0, int nrows) {
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
      const long long gr = r0 + rb + i;
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
    for (int j = lane; j < half_c; j += 32) {
      float2 v[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) v[i] = __bfloat1622float2(drow[i][j]);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (live[i]) {
          reinterpret_cast<bf162*>(a.y + (r0 + rb + i) * c)[j] = __floats2bfloat162_rn(
              (v[i].x - mean[i]) * rstd[i], (v[i].y - mean[i]) * rstd[i]);
        }
      }
    }
  }
}

__device__ __forceinline__ void prefetch_l2_line(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Consumer warpgroup W: the items of queue entries W, W + 2, ...
template <int HP>
__device__ __forceinline__ void ord_consume(const OrdArgs& a, const OrdSmem& s) {
  const int W = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int ww = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int c = a.c;
  const int hid = 4 * c;
  float acc[128];
  for (int qi = W;; qi += 2) {
    const int slot = qi % kOrdQueue;
    mbar_wait(&s.qfull[slot], (qi / kOrdQueue) & 1);
    const int4 it = s.queue[slot];
    mbar_arrive(&s.qempty[slot]);
    if (it.x < 0) break;
    const long long row0 = static_cast<long long>(it.y) * kOrdRows;
    if (it.x == 0) {
      ord_ln_rows<8>(a, row0 + 32 * ww, 32);
      fence_proxy_async_global();
      bar_sync(1 + W, 128);
      if (tid == 0) st_release_u64(ord_flags(a, it.y), a.gen);
      continue;
    }
    const bool fc1 = it.x == 1;
    // the tile's biases into this warpgroup's shared buffer once the last
    // item's epilogue has read it, read after the products; fc2's x rows
    // asked into L2
    float* bias = s.bias + W * kOrdCols;
    const int col0 = it.z * kOrdCols;
    const int ncols = fc1 ? hid : c;
    bar_sync(1 + W, 128);
    bias[tid] = col0 + tid < ncols ? (fc1 ? a.bw : a.b2g)[col0 + tid] : 0.f;
    if (!fc1 && row0 + tid < a.rows) {
      const bf16* xr = a.x + (row0 + tid) * c + col0;
      prefetch_l2_line(xr);
      if (col0 + 64 < c) prefetch_l2_line(xr + 64);
    }
    ord_mainloop(acc, s, fc1 ? a.nk1 : a.nk2, static_cast<uint32_t>(it.w));
    bar_sync(1 + W, 128);   // the biases are in
    // acc[64 hh + 4i + e] is column col0 + 8i + 2t + e of row 64 hh + 16 ww + g,
    // acc[64 hh + 4i + 2 + e] of the row 8 below
    const long long r_lo = row0 + 16 * ww + g;
    if (fc1) {
      // h = bf16(GELU(z + bw))
#pragma unroll
      for (int i = 0; i < kOrdCols / 8; ++i) {
        const int cl = 8 * i + 2 * t;   // 4C is a multiple of 128: no tile is partial
        const float2 b = *reinterpret_cast<const float2*>(bias + cl);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* z = acc + 64 * hh + 4 * i;
          const bf162 lo = __floats2bfloat162_rn(gelu_rational(z[0] + b.x, HP),
                                                 gelu_rational(z[1] + b.y, HP));
          const bf162 hi = __floats2bfloat162_rn(gelu_rational(z[2] + b.x, HP),
                                                 gelu_rational(z[3] + b.y, HP));
          const long long r = r_lo + 64 * hh;
          if (r < a.rows) *reinterpret_cast<bf162*>(a.h + r * hid + col0 + cl) = lo;
          if (r + 8 < a.rows) *reinterpret_cast<bf162*>(a.h + (r + 8) * hid + col0 + cl) = hi;
        }
      }
      fence_proxy_async_global();
      bar_sync(1 + W, 128);
      if (tid == 0) st_release_u64(ord_flags(a, it.y) + 1 + it.z, a.gen);
    } else {
      // out = x + bf16(o + b2g), as the fused epilogue
#pragma unroll
      for (int i = 0; i < kOrdCols / 8; ++i) {
        if (i % 4 == 0) asm volatile("" ::: "memory");   // x loads 4 steps ahead at most
        const int cl = 8 * i + 2 * t;
        const int col = col0 + cl;
        if (col >= c) continue;
        const float2 b = *reinterpret_cast<const float2*>(bias + cl);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e8 = 0; e8 < 2; ++e8) {
            const long long r = r_lo + 64 * hh + 8 * e8;
            if (r >= a.rows) continue;
            const float* o = acc + 64 * hh + 4 * i + 2 * e8;
            const float2 xv =
                __bfloat1622float2(*reinterpret_cast<const bf162*>(a.x + r * c + col));
            const float o0 = __bfloat162float(__float2bfloat16_rn(o[0] + b.x));
            const float o1 = __bfloat162float(__float2bfloat16_rn(o[1] + b.y));
            *reinterpret_cast<bf162*>(a.out + r * c + col) =
                __floats2bfloat162_rn(xv.x + o0, xv.y + o1);
          }
        }
      }
    }
  }
}

template <int HP>
__global__ void __launch_bounds__(kOrdThreads, 1)
ln_mlp_residual_ordered_kernel(const OrdArgs a, const __grid_constant__ CUtensorMap ty,
                               const __grid_constant__ CUtensorMap tw1,
                               const __grid_constant__ CUtensorMap th,
                               const __grid_constant__ CUtensorMap tw2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const OrdSmem s(align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int i = 0; i < kOrdFull; ++i) mbar_init(&s.full[i], 1);
    for (int i = 0; i < kOrdStages; ++i) mbar_init(&s.empty[i], 4);
    for (int i = 0; i < kOrdQueue; ++i) {
      mbar_init(&s.qfull[i], 1);
      mbar_init(&s.qempty[i], 128);
    }
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) ord_produce(a, s, &ty, &tw1, &th, &tw2);
  } else {
    ord_consume<HP>(a, s);
  }
}

// The launch: tensor maps of the scratch buffers and the weights, the grid
// (at most one block per SM); w1t [4C, C] and w2t [C, 4C] bf16. a.plant: 0,
// or the card tests' planted faults (1: the readiness waits skipped, 2: the
// items in row order, where a wait that is missing or satisfied too soon
// shows: in phase order it would seldom matter).
template <int HP>
int launch_ordered(const OrdArgs& a, const void* w1t, const void* w2t, cudaStream_t stream) {
  static size_t smem_configured = 0;   // per instantiation, on the current device
  const int err = raise_smem_limit(ln_mlp_residual_ordered_kernel<HP>,
                                   static_cast<size_t>(kOrdSmem), &smem_configured);
  if (err) return err;
  const int c = a.c;
  const int rows = static_cast<int>(a.rows);
  CUtensorMap ty, tw1, th, tw2;
  int e = box_map(&ty, a.y, 2, c, rows, 128, kOrdRows);
  if (e == 0) e = box_map(&tw1, w1t, 2, c, 4 * c, 128, kOrdCols);
  if (e == 0) e = box_map(&th, a.h, 2, 4 * c, rows, 128, kOrdRows);
  if (e == 0) e = box_map(&tw2, w2t, 2, 4 * c, c, 128, kOrdCols);
  if (e) return e;
  const long long items = ord_total(a);
  const int sms = sm_count();
  const int grid = static_cast<int>(items < sms ? items : sms);
  ln_mlp_residual_ordered_kernel<HP>
      <<<static_cast<unsigned int>(grid), kOrdThreads, kOrdSmem, stream>>>(a, ty, tw1, th, tw2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
