// The bf16 MLP of a row tile on warpgroup MMA, K1's loop (convnext_mlp.cu):
//
//   o[64, cols of a group] = bf16(act(y[64, C] . w1 + b1)) . w2[:, group]   (f32)
//
// for each consumer warpgroup's 64 rows. y is bf16 in shared memory (the
// caller's prologue writes it, 128-byte swizzled in 64-k tiles); w1 and w2
// come transposed (w1t [4C, C], w2t [C, 4C]: K-major, as wgmma reads B).
// The hidden dimension is walked in 64-column chunks: fc1 is m64n64k16 with
// both operands in shared memory into 32 f32 registers; bias and act run on
// those registers and round to bf16, and since the accumulator of m64nNk16
// and an A fragment from registers lay out a row's values alike, the bf16
// pairs are fc2's A operand as they stand (as FlashAttention-3 feeds P into
// P . V): the hidden never touches shared memory. fc2 is m64nNCk16 with A
// from registers into NC / 2 f32 registers per thread.
//
// A block is two consumer warpgroups and a producer warpgroup (one thread
// of which issues the weight copies; setmaxnreg moves most of its registers
// to the consumers). The fc2 sum of 64 rows holds C / 2 registers a thread,
// which fits up to C = 192 beside fc1's, so the output columns split into
// groups of NC = 96, 128 or 192, and fc1 runs once per group: the other choices (sharing h between warpgroups or
// through a cluster's shared memory) need 6-12 warpgroups' registers for
// one 64-row tile at C = 1536, while recomputing costs tensor-core time
// only. Up to C = 384 ("rows" plans) the two warpgroups own 64 rows each of
// a 128-row tile and each computes every group; above, y of 128 rows no
// longer fits beside the ring, and ("cols" plans) both warpgroups share one
// 64-row tile and take alternate groups, two groups per pass over the
// hidden dimension (fc1 recomputed per pass).
//
// The producer streams the weights by TMA (the maps zero-fill past C, so
// no mask is needed) into a ring of stages under full / empty mbarriers:
// per chunk, fc1 stages of 64 x 64 tiles of w1t (two or NC / 64 a stage),
// then one fc2 stage of w2t's NC x 64 tile per group of the pass. The
// consumers share each stage; nothing waits on a block-wide barrier inside
// the loop, and every wgmma is issued unconditionally (k past C multiplies
// zeros), so none is serialized. Where the ring holds a turn's stages
// (all but the widest cols plans, which stream stage by stage), the
// two warpgroups take turns at the tensor cores (one turn: fc2 of a chunk
// and fc1 of the next, one commit, one wait), so that one's GELU, prologue
// and epilogue run under the other's products. Blocks are persistent and
// walk the row tiles; the producer runs ahead into the next tile's weights.
#pragma once

#include "wgmma.cuh"

namespace {

constexpr int kSmemMax = 232448;   // dynamic shared memory a block can use
constexpr int kMlpThreads = 384;   // two consumer warpgroups and the producer's
constexpr int kMlpMisc = 1152;     // 16 mbarriers, then 2 x 64 x 2 f32 row sums

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

template <int NC, bool COLS, bool STREAM>
struct MlpWgmma {
  static constexpr int kStageBytes = mlp_wgmma_stage_bytes(NC);
  static constexpr int kKbs = mlp_wgmma_kbs(NC);   // 64-k tiles of w1t per fc1 stage
  static constexpr int kFc2 = COLS ? 2 : 1;   // fc2 stages per chunk
  static constexpr int kRows = COLS ? 64 : 128;

  static constexpr bool kTurns = !STREAM;   // the warpgroups take turns at the tensor cores

  int c, nkb, stages, fc1_stages, passes;
  bool split;            // a work item is one pass of a tile, not the whole tile
  unsigned char* ys;     // (kRows / 64) x nkb tiles of 64 x 64 bf16
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  float* rowsum;         // [2][64][2]: per warpgroup, row, (sum, sum of squares)

  __device__ __forceinline__ MlpWgmma(unsigned char* smem, int c_, int stages_, bool split_)
      : c(c_), nkb((c_ + 63) / 64), stages(stages_), split(split_) {
    fc1_stages = (nkb + kKbs - 1) / kKbs;
    const int groups = (c_ + NC - 1) / NC;
    passes = COLS ? (groups + 1) / 2 : groups;
    ys = smem;
    ring = smem + mlp_wgmma_ybytes(c_, kRows);
    full = reinterpret_cast<uint64_t*>(ring + stages_ * kStageBytes);
    empty = full + 8;
    rowsum = reinterpret_cast<float*>(full + 16);
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

  // Work items: row tiles, or (split, mlp_wgmma_split; cols plans only)
  // each pass of each row tile.
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

  // The producer (one thread): the weight stream of the block's work items
  // (item0, item0 + stride, ... below nitems), by TMA from w1t [4C, C]
  // (64 x 64 boxes) and w2t [C, 4C] (NC x 64 boxes), whose maps swizzle as
  // wgmma reads and fill zeros past C.
  __device__ __forceinline__ void produce(const CUtensorMap* w1t, const CUtensorMap* w2t,
                                          int item0, int stride, int nitems) const {
    uint32_t q = 0;
    for (int item = item0; item < nitems; item += stride) {
      for (int pass = item_pass0(item); pass < item_pass1(item); ++pass) {
        for (int j = 0; j < chunks(); ++j) {
          for (int f = 0; f < fc1_stages + kFc2; ++f, ++q) {
            const int slot = q % stages;
            mbar_wait(&empty[slot], ((q / stages) & 1) ^ 1);
            unsigned char* dst = ring + slot * kStageBytes;
            if (f < fc1_stages) {
              // w1t rows 64j.. (hidden units), k-blocks f * kKbs ..
              mbar_expect_tx(&full[slot], kKbs * 8192);
              for (int r = 0; r < kKbs; ++r) {
                tma_load_2d(dst + r * 8192, w1t, (f * kKbs + r) * 64, 64 * j, &full[slot]);
              }
            } else {
              // w2t rows (output columns) of group pass * kFc2 + (f - fc1_stages),
              // hidden 64j..64j+63
              mbar_expect_tx(&full[slot], NC * 128);
              tma_load_2d(dst, w2t, 64 * j, (pass * kFc2 + f - fc1_stages) * NC, &full[slot]);
            }
          }
        }
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
  __device__ __forceinline__ void issue_fc1(float* z, int yw, uint32_t k) const {
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
        for (int s = 0; s < 4; ++s) wgmma_ss_n64(z, da + 2 * s, db + 2 * s, 1);
      }
    }
  }

  // fc2 of one chunk from stages k.. (kFc2 of them; the warpgroup's group
  // is stage k + w in cols plans): o += h . w2t tile
  __device__ __forceinline__ void issue_fc2(float* o, const uint32_t (*hf)[4], int w,
                                            uint32_t k) const {
#pragma unroll
    for (int u = 0; u < kFc2; ++u) wait_full(k + u);
    wgmma_fence();
    const uint64_t db = sw128_desc(ring + ((k + (COLS ? w : 0)) % stages) * kStageBytes);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if constexpr (NC == 96) wgmma_rs_n96(o, hf[s], db + 2 * s, 1);
      else if constexpr (NC == 128) wgmma_rs_n128(o, hf[s], db + 2 * s, 1);
      else if constexpr (NC == 192) wgmma_rs_n192(o, hf[s], db + 2 * s, 1);
      else wgmma_rs_n256(o, hf[s], db + 2 * s, 1);
    }
  }

  // bias + act in registers, rounded to bf16: fc2's A fragments. z[4i + e]
  // is hidden column 64j + 8i + 2t + e of row g, z[4i + 2 + e] of row g + 8;
  // k16 step s takes i = 2s (k 2t..) and 2s + 1 (k 2t + 8..).
  template <class Act>
  __device__ __forceinline__ void act_to_a(const float* z, const float2* bias, const Act& act,
                                           uint32_t (*hf)[4]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bf162 ha = __floats2bfloat162_rn(act(z[4 * i] + bias[i].x),
                                             act(z[4 * i + 1] + bias[i].y));
      const bf162 hb = __floats2bfloat162_rn(act(z[4 * i + 2] + bias[i].x),
                                             act(z[4 * i + 3] + bias[i].y));
      hf[i / 2][(i % 2) * 2] = bf162_bits(ha);
      hf[i / 2][(i % 2) * 2 + 1] = bf162_bits(hb);
    }
  }

  __device__ __forceinline__ void load_bias(const float* b1, int j, float2* bias) const {
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) bias[i] = *reinterpret_cast<const float2*>(b1 + 64 * j + 8 * i + 2 * t);
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
  // 64 rows of y tile row block yw (its y tiles written and visible). q is
  // the warpgroup's stage count; `last` marks the warpgroup's last pass of
  // the kernel. A turn issues fc2 of chunk j - 1 and fc1 of chunk j with
  // one commit and one wait; every wgmma is issued unconditionally.
  template <class Act>
  __device__ __forceinline__ void pass(int w, int yw, const float* b1, const Act& act, float* o,
                                       uint32_t& q, bool last) const {
    const int n = chunks();
    float z[32];
    float2 bias[8];
    uint32_t hf[4][4];
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) o[e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 32; ++e) z[e] = 0.0f;
    load_bias(b1, 0, bias);
    turn_begin(w);
    issue_fc1(z, yw, q);
    wgmma_commit();
    turn_end(w, true);
    wgmma_wait<0>();
    fence_regs<32>(z);
    release(q, q + fc1_stages);
    q += fc1_stages;
    act_to_a(z, bias, act, hf);
    for (int j = 1; j < n; ++j) {
      load_bias(b1, j, bias);
#pragma unroll
      for (int e = 0; e < 32; ++e) z[e] = 0.0f;
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
      act_to_a(z, bias, act, hf);
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

  // The same pass stage by stage (STREAM plans): each stage is released as
  // soon as its products are done, so a ring shorter than a turn serves.
  template <class Act>
  __device__ __forceinline__ void pass_stream(int w, int yw, const float* b1, const Act& act,
                                              float* o, uint32_t& q) const {
    float z[32];
    float2 bias[8];
    uint32_t hf[4][4];
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) o[e] = 0.0f;
    for (int j = 0; j < chunks(); ++j) {
      load_bias(b1, j, bias);
#pragma unroll
      for (int e = 0; e < 32; ++e) z[e] = 0.0f;
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
          for (int s = 0; s < 4; ++s) wgmma_ss_n64(z, da + 2 * s, db + 2 * s, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(z);
        release(q, q + 1);
      }
      act_to_a(z, bias, act, hf);
      issue_fc2(o, hf, w, q);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NC / 2>(o);
      release(q, q + kFc2);
      q += kFc2;
    }
  }
};

}  // namespace
