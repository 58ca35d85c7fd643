// The MLP of a block tail on warpgroup MMA, the loop of K1 (convnext_mlp.cu)
// and K4 (convnext_mlp_int8.cu), and through block_wgmma.cuh of K5 and K6:
//
//   o[64, cols of a group] = act(y[64, C] . w1 + b1) . w2[:, group]
//
// for each consumer warpgroup's 64 rows. y is in shared memory (the
// caller's prologue writes it, 128-byte swizzled in tiles of 64 rows x 128
// bytes); w1 and w2 come K-major (w1t [4C, C], w2t [C, 4C], the reduced
// dimension contiguous, as wgmma reads B). The operand types are template
// arguments: fc1 is bf16 (K1: 64 k a tile row, m64n64k16) or s8 (K4: 128 k,
// m64n64k32 into s32), fc2 bf16 (m64nNCk16 into f32) or s8 (K4 'full':
// m64nNCk32 into s32, w2t tiles of 64-byte rows in the 64-byte swizzle).
// The hidden dimension is walked in 64-column chunks: fc1 of a chunk, both
// operands in shared memory, leaves 32 accumulator registers a thread; the
// caller's chunk functor turns them into fc2's A fragments (bias or
// dequantization, the GELU, rounding to bf16 or quantizing to s8). Since the
// accumulator of m64nN and an A fragment from registers lay out a row's
// values alike (in s8 up to a fixed permutation of k inside each 32-block,
// which K4 puts into its fc2 weights), the fragments are fc2's A operand as
// they stand (as FlashAttention-3 feeds P into P . V): the hidden never
// touches shared memory. fc2 accumulates into NC / 2 registers per thread.
//
// A block is two consumer warpgroups and a producer warpgroup (one thread
// of which issues the weight copies; setmaxnreg moves most of its registers
// to the consumers). The fc2 sum of 64 rows holds C / 2 registers a thread,
// which fits up to C = 192 beside fc1's, so the output columns split into
// groups of NC = 96, 128 or 192, and fc1 runs once per group: the other
// choices (sharing h between warpgroups or through a cluster's shared
// memory) need 6-12 warpgroups' registers for one 64-row tile at C = 1536,
// while recomputing costs tensor-core time only. In "rows" plans the two
// warpgroups own 64 rows each of a 128-row tile and each computes every
// group; where y of 128 rows no longer fits beside the ring ("cols" plans)
// both warpgroups share one 64-row tile and take alternate groups, two
// groups per pass over the hidden dimension (fc1 recomputed per pass).
// K4's 'full' mode quantizes the hidden per row, over all 4C values, so a
// row-maxima pass (fc1 and the chunk functor's reduction only) comes first.
//
// The producer streams the weights by TMA (the maps zero-fill past C, so
// no mask is needed) into a ring of stages under full / empty mbarriers:
// per chunk, fc1 stages of 64 x 128-byte tiles of w1t (KB a stage), then
// one fc2 stage of w2t's NC x 64 tile per group of the pass. The consumers
// share each stage; nothing waits on a block-wide barrier inside the loop,
// and every wgmma is issued unconditionally (k past C multiplies zeros), so
// none is serialized. Where the ring holds a turn's stages (every K4 plan,
// all but the widest K1 cols plans, which stream stage by stage), the two
// warpgroups take turns at the tensor cores (one turn: fc2 of a chunk and
// fc1 of the next, one commit, one wait), so that one's GELU, prologue and
// epilogue run under the other's products. Blocks are persistent and walk
// the row tiles; the producer runs ahead into the next tile's weights.
//
// mlp_consumer is the consumer warpgroups' whole work per tile, shared by
// K1 and K4: the caller's prologue (LayerNorm, y into shared memory), the
// passes, and the epilogue on the fc2 accumulator in registers (the
// residual add, or the post-LN). K5 and K6 run the same passes and ring
// from their own consumer and schedule (block_wgmma.cuh).
#pragma once

#include "wgmma.cuh"

namespace {

constexpr int kSmemMax = 232448;   // dynamic shared memory a block can use
constexpr int kMlpThreads = 384;   // two consumer warpgroups and the producer's
constexpr int kMlpMisc = 1152;     // 16 mbarriers, then 2 x 64 x 2 f32 row sums
constexpr int kMlpRowScales = 512;  // K4: then 128 f32 per-row scales

// K1's tile plan at width c: rows per block (128: "rows", 64: "cols"),
// output columns per group (NC), ring stages and shared-memory bytes; rows
// 0 where c is not a multiple of 32 in [32, 1536].
struct MlpPlan {
  int rows, cols, stages, smem;
};

__host__ __device__ constexpr int mlp_wgmma_ybytes(int c, int rows) {
  return rows * ((c + 63) / 64) * 128;
}

// 64-k tiles of w1t per fc1 stage, and the bytes of a stage: an fc2 stage
// holds NC rows of 128 bytes, an fc1 stage kbs 64 x 64 tiles.
__host__ __device__ constexpr int mlp_wgmma_kbs(int nc) { return nc < 128 ? 2 : nc / 64; }
__host__ __device__ constexpr int mlp_wgmma_stage_bytes(int nc) {
  return nc * 128 > mlp_wgmma_kbs(nc) * 8192 ? nc * 128 : mlp_wgmma_kbs(nc) * 8192;
}

__host__ __device__ constexpr int mlp_wgmma_stages(int c, int rows, int nc) {
  return (kSmemMax - 1024 - mlp_wgmma_ybytes(c, rows) - kMlpMisc) / mlp_wgmma_stage_bytes(nc) < 8
             ? (kSmemMax - 1024 - mlp_wgmma_ybytes(c, rows) - kMlpMisc) / mlp_wgmma_stage_bytes(nc)
             : 8;
}

__host__ __device__ inline MlpPlan mlp_wgmma_plan(int c) {
  MlpPlan p = {0, 0, 0, 0};
  if (c < 32 || c > 1536 || c % 32 != 0) return p;
  const int rows = c <= 384 ? 128 : 64;
  const int cand_rows[3] = {192, 128, 96};
  const int cand_cols[3] = {192, 128, 0};
  const int* cand = rows == 128 ? cand_rows : cand_cols;
  int best = 0, best_cost = 0;
  for (int i = 0; i < 3; ++i) {   // fewest columns computed, then the widest groups
    const int nc = cand[i];
    if (nc == 0 || mlp_wgmma_stages(c, rows, nc) < 2) continue;
    const int groups = (c + nc - 1) / nc;
    const int cost = (rows == 128 ? groups : (groups + 1) / 2 * 2) * nc;
    if (best == 0 || cost < best_cost) {
      best = nc;
      best_cost = cost;
    }
  }
  if (best == 0) return p;
  p.rows = rows;
  p.cols = best;
  p.stages = mlp_wgmma_stages(c, rows, best);
  p.smem = 1024 + mlp_wgmma_ybytes(c, rows) + p.stages * mlp_wgmma_stage_bytes(best) + kMlpMisc;
  return p;
}

// Passes over the hidden dimension per row tile (fc1 runs once per pass).
__host__ __device__ inline int mlp_wgmma_passes(int c, const MlpPlan& p) {
  const int groups = (c + p.cols - 1) / p.cols;
  return p.rows == 128 ? groups : (groups + 1) / 2;
}

// Whether K1 hands out each pass of a row tile as a work item of its own:
// in cols plans without the post-LN (which needs every column of a row in
// one block), where that takes fewer rounds of items over the SMs than
// whole tiles do (few rows: the late stages, the small reconstructions).
__host__ __device__ inline bool mlp_wgmma_split(int c, const MlpPlan& p, long long rows,
                                                bool post, int sms) {
  const int passes = mlp_wgmma_passes(c, p);
  if (p.rows == 128 || post || passes < 2) return false;
  const long long tiles = (rows + p.rows - 1) / p.rows;
  return (tiles * passes + sms - 1) / sms < (tiles + sms - 1) / sms * passes;
}

// Whether the ring is too short for a turn (fc2 of a chunk and fc1 of the
// next: all fc1 stages of a chunk and its fc2 stages held at once); then
// the warpgroups stream stage by stage, releasing each when its products
// are done, and take no turns.
__host__ __device__ inline bool mlp_wgmma_stream(int c, const MlpPlan& p) {
  const int kbs = mlp_wgmma_kbs(p.cols);
  return p.stages < ((c + 63) / 64 + kbs - 1) / kbs + (p.rows == 128 ? 1 : 2);
}

// fc1's operand type: y and w1t tiles of 64 rows x 128 bytes, kK values a
// row, four k steps of 32 bytes a tile.
struct Fc1Bf16 {
  using Acc = float;
  static constexpr int kK = 64;
  __device__ __forceinline__ static void mma(float* z, uint64_t a, uint64_t b) {
    wgmma_ss_n64(z, a, b, 1);
  }
};

struct Fc1S8 {
  using Acc = int;
  static constexpr int kK = 128;
  __device__ __forceinline__ static void mma(int* z, uint64_t a, uint64_t b) {
    wgmma_ss_n64_s8(z, a, b, 1);
  }
};

// fc2's operand type: a 64-hidden chunk is kSteps k steps of A fragments
// (bf16 k16 or s8 k32) against a w2t tile of NC rows of 64 hidden values
// (128 bytes, 128-byte swizzle; or 64 bytes, 64-byte swizzle).
struct Fc2Bf16 {
  using Acc = float;
  static constexpr int kSteps = 4;
  static constexpr bool kInt8 = false;
  __host__ __device__ static constexpr int bytes(int nc) { return nc * 128; }
  __device__ __forceinline__ static uint64_t desc(const void* p) { return sw128_desc(p); }
  template <int NC>
  __device__ __forceinline__ static void mma(float* o, const uint32_t* a, uint64_t b) {
    if constexpr (NC == 96) wgmma_rs_n96(o, a, b, 1);
    else if constexpr (NC == 128) wgmma_rs_n128(o, a, b, 1);
    else if constexpr (NC == 192) wgmma_rs_n192(o, a, b, 1);
    else wgmma_rs_n256(o, a, b, 1);
  }
};

struct Fc2S8 {
  using Acc = int;
  static constexpr int kSteps = 2;
  static constexpr bool kInt8 = true;
  __host__ __device__ static constexpr int bytes(int nc) { return nc * 64; }
  __device__ __forceinline__ static uint64_t desc(const void* p) { return sw64_desc(p); }
  template <int NC>
  __device__ __forceinline__ static void mma(int* o, const uint32_t* a, uint64_t b) {
    if constexpr (NC == 96) wgmma_rs_n96_s8(o, a, b, 1);
    else if constexpr (NC == 128) wgmma_rs_n128_s8(o, a, b, 1);
    else wgmma_rs_n192_s8(o, a, b, 1);
  }
};

// An accumulator element as f32: K4's s32 fc2 sums hold f32 bits once
// dequantized (the chunk functor's fc2_done).
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(int v) { return __int_as_float(v); }
__device__ __forceinline__ void set_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void set_f32(int& d, float v) { d = __float_as_int(v); }

template <int NC_, bool COLS, bool STREAM, class F1 = Fc1Bf16, class F2 = Fc2Bf16,
          int KB = mlp_wgmma_kbs(NC_)>
struct MlpWgmma {
  static constexpr int NC = NC_;
  static constexpr bool kCols = COLS;
  static constexpr bool kStream = STREAM;
  static constexpr int kKbs = KB;   // w1t tiles per fc1 stage
  static constexpr int kStageBytes = KB * 8192 > F2::bytes(NC) ? KB * 8192 : F2::bytes(NC);
  static constexpr int kFc2 = COLS ? 2 : 1;   // fc2 stages per chunk
  static constexpr int kRows = COLS ? 64 : 128;
  static constexpr bool kTurns = !STREAM;   // the warpgroups take turns at the tensor cores
  static constexpr bool kRowMax = F2::kInt8;   // K4 'full': the row-maxima pass first
  using Acc1 = typename F1::Acc;
  using Acc2 = typename F2::Acc;

  int c, nkb, stages, fc1_stages, passes;
  bool split;            // a work item is one pass of a tile, not the whole tile
  unsigned char* ys;     // (kRows / 64) x nkb tiles of 64 rows x 128 bytes
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  float* rowsum;         // [2][64][2]: per warpgroup, row, (sum, sum of squares)
  float* rowscale;       // [128]: K4's per-row y scales (sa)

  __device__ __forceinline__ MlpWgmma(unsigned char* smem, int c_, int stages_, bool split_)
      : c(c_), nkb((c_ + F1::kK - 1) / F1::kK), stages(stages_), split(split_) {
    fc1_stages = (nkb + kKbs - 1) / kKbs;
    const int groups = (c_ + NC - 1) / NC;
    passes = COLS ? (groups + 1) / 2 : groups;
    ys = smem;
    ring = smem + kRows * nkb * 128;
    full = reinterpret_cast<uint64_t*>(ring + stages_ * kStageBytes);
    empty = full + 8;
    rowsum = reinterpret_cast<float*>(full + 16);
    rowscale = rowsum + 256;
  }

  __device__ __forceinline__ int chunks() const { return c / 16; }   // 4C / 64

  // one thread, then a block barrier
  __device__ __forceinline__ void init_barriers() const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);    // the producer's one arrival, with the bytes
      mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
  }

  // y tile of rows 64 w.. (w = 0 in cols plans), k-block kb
  __device__ __forceinline__ unsigned char* y_tile(int w, int kb) const {
    return ys + (w * nkb + kb) * 8192;
  }

  // Work items: row tiles, or (split, cols plans only: mlp_wgmma_split,
  // k4_launch_plan) each pass of each row tile.
  __device__ __forceinline__ int items(long long rows) const {
    const int tiles = static_cast<int>((rows + kRows - 1) / kRows);
    if constexpr (COLS) return split ? tiles * passes : tiles;
    return tiles;
  }
  __device__ __forceinline__ int item_tile(int item) const {
    if constexpr (COLS) return split ? item / passes : item;
    return item;
  }
  __device__ __forceinline__ int item_pass0(int item) const {
    if constexpr (COLS) return split ? item % passes : 0;
    return 0;
  }
  __device__ __forceinline__ int item_pass1(int item) const {
    if constexpr (COLS) return split ? item % passes + 1 : passes;
    return passes;
  }

  // fc1 stage f of chunk j into ring slot `slot`: w1t rows 64j.. (hidden
  // units), k-blocks f * kKbs ..; blk >= 0: block blk of a 3-D map (K5, K6)
  __device__ __forceinline__ void load_fc1(const CUtensorMap* w1t, int slot, int f, int j,
                                           int blk) const {
    unsigned char* dst = ring + slot * kStageBytes;
    mbar_expect_tx(&full[slot], kKbs * 8192);
    for (int r = 0; r < kKbs; ++r) {
      if (blk >= 0) {
        tma_load_3d(dst + r * 8192, w1t, (f * kKbs + r) * F1::kK, 64 * j, blk, &full[slot]);
      } else {
        tma_load_2d(dst + r * 8192, w1t, (f * kKbs + r) * F1::kK, 64 * j, &full[slot]);
      }
    }
  }

  // The weight stream of one pass (every chunk's fc1 stages, then its fc2
  // stages of the pass's groups), from stage q on.
  __device__ __forceinline__ void produce_pass(const CUtensorMap* w1t, const CUtensorMap* w2t,
                                               int pass, int blk, uint32_t& q) const {
    for (int j = 0; j < chunks(); ++j) {
      for (int f = 0; f < fc1_stages + kFc2; ++f, ++q) {
        const int slot = q % stages;
        mbar_wait(&empty[slot], ((q / stages) & 1) ^ 1);
        unsigned char* dst = ring + slot * kStageBytes;
        if (f < fc1_stages) {
          load_fc1(w1t, slot, f, j, blk);
        } else {
          // w2t rows (output columns) of group pass * kFc2 + (f - fc1_stages),
          // hidden 64j..64j+63
          const int col0 = (pass * kFc2 + f - fc1_stages) * NC;
          mbar_expect_tx(&full[slot], F2::bytes(NC));
          if (blk >= 0) {
            tma_load_3d(dst, w2t, 64 * j, col0, blk, &full[slot]);
          } else {
            tma_load_2d(dst, w2t, 64 * j, col0, &full[slot]);
          }
        }
      }
    }
  }

  // The producer (one thread): the weight stream of the block's work items
  // (item0, item0 + stride, ... below nitems), by TMA from w1t [4C, C]
  // (64 x 128-byte boxes) and w2t [C, 4C] (NC x 64-value boxes), whose maps
  // swizzle as wgmma reads and fill zeros past C. With kRowMax each item
  // starts with the fc1 stages of every chunk (the row-maxima pass). The
  // block kernels (block_wgmma.cuh) stream their own schedule with
  // produce_pass.
  __device__ __forceinline__ void produce(const CUtensorMap* w1t, const CUtensorMap* w2t,
                                          int item0, int stride, int nitems) const {
    uint32_t q = 0;
    for (int item = item0; item < nitems; item += stride) {
      if constexpr (kRowMax) {
        for (int j = 0; j < chunks(); ++j) {
          for (int f = 0; f < fc1_stages; ++f, ++q) {
            const int slot = q % stages;
            mbar_wait(&empty[slot], ((q / stages) & 1) ^ 1);
            load_fc1(w1t, slot, f, j, -1);
          }
        }
      }
      for (int pass = item_pass0(item); pass < item_pass1(item); ++pass) {
        produce_pass(w1t, w2t, pass, -1, q);
      }
    }
  }

  __device__ __forceinline__ void wait_full(uint32_t k) const {
    mbar_wait(&full[k % stages], (k / stages) & 1);
  }

  __device__ __forceinline__ void release(uint32_t k0, uint32_t k1) const {
    if (threadIdx.x % 32 == 0) {
      for (uint32_t k = k0; k < k1; ++k) mbar_arrive(&empty[k % stages]);
    }
  }

  // fc1 of one chunk from stages k..: z += y . w1t chunk (z zeroed by the caller)
  __device__ __forceinline__ void issue_fc1(Acc1* z, int yw, uint32_t k) const {
    for (int f = 0; f < fc1_stages; ++f) {
      wait_full(k + f);
      wgmma_fence();
      const unsigned char* st = ring + ((k + f) % stages) * kStageBytes;
#pragma unroll
      for (int r = 0; r < kKbs; ++r) {
        const int kb = f * kKbs + r;
        // a k-block past the y tiles pairs tile 0 with a zero w1t tile
        const uint64_t da = sw128_desc(y_tile(yw, kb < nkb ? kb : 0));
        const uint64_t db = sw128_desc(st + r * 8192);
#pragma unroll
        for (int s = 0; s < 4; ++s) F1::mma(z, da + 2 * s, db + 2 * s);
      }
    }
  }

  // fc2 of one chunk from stages k.. (kFc2 of them; the warpgroup's group
  // is stage k + w in cols plans): o += h . w2t tile
  __device__ __forceinline__ void issue_fc2(Acc2* o, const uint32_t (*hf)[4], int w,
                                            uint32_t k) const {
#pragma unroll
    for (int u = 0; u < kFc2; ++u) wait_full(k + u);
    wgmma_fence();
    const uint64_t db = F2::desc(ring + ((k + (COLS ? w : 0)) % stages) * kStageBytes);
#pragma unroll
    for (int s = 0; s < F2::kSteps; ++s) F2::template mma<NC>(o, hf[s], db + 2 * s);
  }

  // With pingpong, a warpgroup's turn at the tensor cores: wait for it, and
  // hand it on once its products are issued (FlashAttention-3's schedule:
  // one warpgroup's GELU runs under the other's products).
  __device__ __forceinline__ void turn_begin(int w) const {
    if constexpr (kTurns) bar_sync(4 + w, 256);
  }
  __device__ __forceinline__ void turn_end(int w, bool hand_on) const {
    if constexpr (kTurns) {
      if (hand_on) bar_arrive(4 + (1 - w), 256);
    }
  }

  // Consumer warpgroup w, one pass: o = the fc2 sums of its group for the
  // 64 rows of y tile row block yw (its y tiles written and visible). ch is
  // the chunk functor: ch.load(j) before chunk j's products are issued,
  // ch.convert(z, hf) after, z -> fc2's A fragments. q is the warpgroup's
  // stage count; `last` marks the warpgroup's last pass of the kernel. A
  // turn issues fc2 of chunk j - 1 and fc1 of chunk j with one commit and
  // one wait; every wgmma is issued unconditionally.
  template <class Chunk>
  __device__ __forceinline__ void pass(int w, int yw, Chunk& ch, Acc2* o, uint32_t& q,
                                       bool last) const {
    const int n = chunks();
    Acc1 z[32];
    uint32_t hf[F2::kSteps][4];
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) o[e] = 0;
#pragma unroll
    for (int e = 0; e < 32; ++e) z[e] = 0;
    ch.load(0);
    turn_begin(w);
    issue_fc1(z, yw, q);
    wgmma_commit();
    turn_end(w, true);
    wgmma_wait<0>();
    fence_regs<32>(z);
    release(q, q + fc1_stages);
    q += fc1_stages;
    ch.convert(z, hf);
    for (int j = 1; j < n; ++j) {
      ch.load(j);
#pragma unroll
      for (int e = 0; e < 32; ++e) z[e] = 0;
      turn_begin(w);
      issue_fc2(o, hf, w, q);
      issue_fc1(z, yw, q + kFc2);
      wgmma_commit();
      turn_end(w, true);
      wgmma_wait<0>();
      fence_regs<NC / 2>(o);
      fence_regs<32>(z);
      release(q, q + kFc2 + fc1_stages);
      q += kFc2 + fc1_stages;
      ch.convert(z, hf);
    }
    turn_begin(w);
    issue_fc2(o, hf, w, q);
    wgmma_commit();
    turn_end(w, !(last && w == 1));   // warpgroup 1 took the first turn's hand-off
    wgmma_wait<0>();
    fence_regs<NC / 2>(o);
    release(q, q + kFc2);
    q += kFc2;
  }

  // The row-maxima pass (kRowMax): fc1 of every chunk in turns, each
  // chunk's accumulator handed to ch.reduce(z).
  template <class Chunk>
  __device__ __forceinline__ void pass_max(int w, int yw, Chunk& ch, uint32_t& q) const {
    Acc1 z[32];
    for (int j = 0; j < chunks(); ++j) {
      ch.load(j);
#pragma unroll
      for (int e = 0; e < 32; ++e) z[e] = 0;
      turn_begin(w);
      issue_fc1(z, yw, q);
      wgmma_commit();
      turn_end(w, true);
      wgmma_wait<0>();
      fence_regs<32>(z);
      release(q, q + fc1_stages);
      q += fc1_stages;
      ch.reduce(z);
    }
  }

  // The same pass stage by stage (STREAM plans): each stage is released as
  // soon as its products are done, so a ring shorter than a turn serves.
  template <class Chunk>
  __device__ __forceinline__ void pass_stream(int w, int yw, Chunk& ch, Acc2* o,
                                              uint32_t& q) const {
    Acc1 z[32];
    uint32_t hf[F2::kSteps][4];
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) o[e] = 0;
    for (int j = 0; j < chunks(); ++j) {
      ch.load(j);
#pragma unroll
      for (int e = 0; e < 32; ++e) z[e] = 0;
      for (int f = 0; f < fc1_stages; ++f, ++q) {
        wait_full(q);
        wgmma_fence();
        const unsigned char* st = ring + (q % stages) * kStageBytes;
#pragma unroll
        for (int r = 0; r < kKbs; ++r) {
          const int kb = f * kKbs + r;
          const uint64_t da = sw128_desc(y_tile(yw, kb < nkb ? kb : 0));
          const uint64_t db = sw128_desc(st + r * 8192);
#pragma unroll
          for (int s = 0; s < 4; ++s) F1::mma(z, da + 2 * s, db + 2 * s);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(z);
        release(q, q + 1);
      }
      ch.convert(z, hf);
      issue_fc2(o, hf, w, q);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NC / 2>(o);
      release(q, q + kFc2);
      q += kFc2;
    }
  }
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

// Consumer warpgroup W of a block: every tile's prologue, passes and
// epilogue. In rows plans it owns rows 64 W.. of each 128-row tile; in cols
// plans both share a 64-row tile and W takes groups W, W + 2, ...
// The kernel's Tail supplies its arguments (tail.a: d, x, b2g, lns, lnb,
// vbuf, out, rows, c), its prologue (tail.rows_to_y<RB>: LayerNorm and y of
// RB rows at a time into the y tiles, and K4's row scales), its chunk
// functor (tail.chunk()), tail.begin_rows (the functor's per-tile row
// state) and tail.fc2_done (the fc2 sums to f32 before the epilogue).
template <class Tail, class Mlp>
__device__ __forceinline__ void mlp_consumer(const Tail& tail, const Mlp& mlp) {
  constexpr int NC = Mlp::NC;
  constexpr bool COLS = Mlp::kCols;
  constexpr int kTile = Mlp::kRows;
  const auto& a = tail.a;
  const int W = threadIdx.x / 128;
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
  typename Mlp::Acc2 o[NC / 2];
  auto ch = tail.chunk();
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
      tail.template rows_to_y<4>(mlp.y_tile(0, 0), tile0, 8 * (4 * W + ww), 8, mlp.nkb,
                                 mlp.rowscale);
      fence_proxy_async();
      bar_sync(1, 256);
    } else {
      tail.template rows_to_y<8>(mlp.y_tile(W, 0), row0 - 64 * W, 64 * W + 16 * ww, 16, mlp.nkb,
                                 mlp.rowscale);
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
    tail.begin_rows(ch, mlp.rowscale + 64 * yw + 16 * ww + g);
    if constexpr (Mlp::kRowMax) {
      mlp.pass_max(W, yw, ch, q);
      ch.end_max();
    }

    // 2. per pass: fc1 -> GELU -> fc2 (o), then the epilogue on the group's
    //    columns: o[4i + 2h + e] is column grp * NC + 8i + 2t + e of row 16 ww
    //    + g + 8h.
    const long long ra = row0 + 16 * ww + g;
    float rsum[2] = {0.f, 0.f}, rsq[2] = {0.f, 0.f};
    for (int ps = p0; ps < p1; ++ps) {
      if constexpr (Mlp::kStream) {
        mlp.pass_stream(W, yw, ch, o, q);
      } else {
        mlp.pass(W, yw, ch, o, q, last_item && ps == p1 - 1);
      }
      const int grp = COLS ? 2 * ps + W : ps;
      tail.fc2_done(ch, o, grp * NC);
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
            float v0 = as_f32(o[4 * i + 2 * h]);
            float v1 = as_f32(o[4 * i + 2 * h + 1]);
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
              set_f32(o[4 * i + 2 * h], v0);
              set_f32(o[4 * i + 2 * h + 1], v1);
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
      rstd[h] = rsqrtf(rsq[h] * inv_c - mean[h] * mean[h] + a.eps);
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
          float2 v = make_float2(as_f32(o[4 * i + 2 * h]), as_f32(o[4 * i + 2 * h + 1]));
          if (passes > 1) v = *reinterpret_cast<const float2*>(a.vbuf + r * c + col);
          *reinterpret_cast<bf162*>(a.out + r * c + col) = __floats2bfloat162_rn(
              (v.x - mean[h]) * rstd[h] * a.lns[col] + a.lnb[col],
              (v.y - mean[h]) * rstd[h] * a.lns[col + 1] + a.lnb[col + 1]);
        }
      }
    }
  }
}

// A block of a kernel on this loop: the barriers, then the producer
// warpgroup's one streaming thread and the two consumer warpgroups.
template <class Tail, class Mlp>
__device__ __forceinline__ void mlp_block(const Tail& tail, const Mlp& mlp,
                                          const CUtensorMap* tm1, const CUtensorMap* tm2) {
  if (threadIdx.x == 0) mlp.init_barriers();
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    // the producer warpgroup streams; most of its registers go to the
    // consumers (2 x 128 x 224 + 128 x 56 = 168 x 384)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == 256) mlp.produce(tm1, tm2, blockIdx.x, gridDim.x, mlp.items(tail.a.rows));
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    mlp_consumer(tail, mlp);
  }
}

}  // namespace
