// The bf16 MLP of one row tile on the tensor cores (WMMA): the first design
// of K5's and K6's MLP, now the block-phase probe M2's (block_parts.cu)
// alone; K1, K4, K5 and K6 run on the warpgroup-MMA loop of mlp_wgmma.cuh:
//
//   os[BM, C] = act(ys[BM, C] . w1[C, 4C] + b1) . w2[4C, C]     (f32, no fc2 bias)
//
// ys is bf16 in shared memory, written by the caller's prologue; act's result
// is rounded to bf16 before fc2. The [BM, 4C] hidden never leaves shared
// memory: a block walks the hidden dimension in 128-column chunks (fc1 for
// the chunk, then bias + act through a per-warp 16x16 staging tile into bf16
// h, then the fc2 partial into register accumulators). The weights
// (L2-resident) stream through a ring of shared-memory stages in 32-row
// (fc1) and 16-row (fc2) slices with cp.async, several slices ahead of the
// tensor cores, shared by all 8 warps; WMMA, bf16 in, f32 accumulate. BM
// (64/32/16 rows for C up to 192/384/768) keeps the fc2 accumulator at 6
// WMMA tiles per warp at most; the warps tile (row strips) x (column tiles).
// kFc2 = false (the block-phase probe, block_parts.cu) stops after act: the
// slice stream carries no fc2 slices, and run() writes the first C columns
// of bf16(act(hidden)) to device memory instead of computing os.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHidChunk = 128;    // hidden columns per chunk
constexpr int kMaxNt = 6;         // fc2 accumulator 16x16 tiles per warp
constexpr int kPadBf16 = 8;       // shared-row padding (bank spread)
constexpr int kPadF32 = 4;
constexpr int kScratchLd = 16;    // per-warp 16x16 f32 staging row stride
constexpr int kKs1 = 32;          // rows of w1 per fc1 weight slice
constexpr int kKs2 = 16;          // rows of w2 per fc2 weight slice

// Row tile per width: BM=64 for C<=192, 32 for C<=384, 16 for C<=768.
__host__ __device__ constexpr int mlp_row_tile(int c) {
  return c <= 192 ? 64 : c <= 384 ? 32 : 16;
}

// Ring stages per row tile, so that two blocks fit on an SM at every width.
__host__ __device__ constexpr int mlp_stages(int bm) { return bm == 16 ? 3 : 4; }

// Shared memory of one block (byte offsets; ys starts at 0): ys (bf16), the
// act'ed hidden chunk (bf16), one 16x16 f32 staging tile per warp, and the
// ring of weight-slice stages, which the f32 fc2 result os reuses at the end.
struct MlpSmem {
  size_t hs, scratch, ring, stage, total;
};

__host__ __device__ __forceinline__ MlpSmem mlp_smem(int c, int bm) {
  MlpSmem s;
  s.hs = align128(static_cast<size_t>(bm) * (c + kPadBf16) * sizeof(bf16));
  s.scratch = s.hs + align128(static_cast<size_t>(bm) * (kHidChunk + kPadBf16) * sizeof(bf16));
  s.ring = s.scratch + align128(static_cast<size_t>(kWarps) * 16 * kScratchLd * sizeof(float));
  const size_t w1 = static_cast<size_t>(kKs1) * (kHidChunk + kPadBf16) * sizeof(bf16);
  const size_t w2 = static_cast<size_t>(kKs2) * (c + kPadBf16) * sizeof(bf16);
  s.stage = align128(w1 > w2 ? w1 : w2);
  const size_t ring = mlp_stages(bm) * s.stage;
  const size_t os = align128(static_cast<size_t>(bm) * (c + kPadF32) * sizeof(float));
  s.total = s.ring + (ring > os ? ring : os);
  return s;
}

// Use: construct, prefetch() (the first slices fly during the caller's
// prologue; a prologue that uses os as scratch syncs before it), write ys
// rows [0, BM) (zeros past a ragged end), run(act), read os rows; the
// caller syncs before the ring is reused.
template <int BM, bool kFc2 = true>
struct MlpTile {
  static constexpr int kWM = BM / 16;                 // warp rows (16-row strips)
  static constexpr int kWN = kWarps / kWM;            // warp columns
  static constexpr int kNj1 = kHidChunk / 16 / kWN;   // fc1 tiles per warp per chunk
  static constexpr int kS2 = kHidChunk / kKs2;        // fc2 slices per chunk
  static constexpr int kStages = mlp_stages(BM);
  static constexpr int ldw1 = kHidChunk + kPadBf16;
  static constexpr int ldh = kHidChunk + kPadBf16;

  const bf16* w1;
  const float* b1;
  const bf16* w2;
  int c;
  int ldy, ldo;
  bf16* ys;
  bf16* hs;
  float* scratch;   // this warp's staging tile
  bf16* ring;
  float* os;
  size_t stage_elems;

  __device__ __forceinline__ MlpTile(unsigned char* smem, int c_, const bf16* w1_,
                                     const float* b1_, const bf16* w2_)
      : w1(w1_), b1(b1_), w2(w2_), c(c_), ldy(c_ + kPadBf16), ldo(c_ + kPadF32) {
    const MlpSmem lay = mlp_smem(c_, BM);
    ys = reinterpret_cast<bf16*>(smem);
    hs = reinterpret_cast<bf16*>(smem + lay.hs);
    scratch = reinterpret_cast<float*>(smem + lay.scratch) + (threadIdx.x / 32) * 16 * kScratchLd;
    ring = reinterpret_cast<bf16*>(smem + lay.ring);
    os = reinterpret_cast<float*>(smem + lay.ring);
    stage_elems = lay.stage / sizeof(bf16);
  }

  static constexpr int kFc2Slices = kFc2 ? kS2 : 0;   // fc2 slices per chunk

  __device__ __forceinline__ int slices() const {
    return (4 * c / kHidChunk) * (c / kKs1 + kFc2Slices);
  }

  // Issue the copies of weight slice g (chunk g / spc; its fc1 slices
  // first, then its fc2 slices) into ring stage g % kStages, 16 bytes per
  // cp.async, as one copy group (empty past the last slice, which keeps the
  // group count per loop step fixed).
  __device__ __forceinline__ void load_slice(int g) const {
    const int hidden = 4 * c;
    const int s1 = c / kKs1;
    const int spc = s1 + kFc2Slices;
    if (g < slices()) {
      bf16* dst = ring + (g % kStages) * stage_elems;
      const int h0 = (g / spc) * kHidChunk;
      const int s = g % spc;
      if (s < s1) {
        const bf16* src = w1 + static_cast<size_t>(s * kKs1) * hidden + h0;
        constexpr int kPerRow = kHidChunk / 8;
        for (int i = threadIdx.x; i < kKs1 * kPerRow; i += kThreads) {
          const int r = i / kPerRow;
          const int q = i % kPerRow;
          cp_async16(dst + r * ldw1 + q * 8, src + static_cast<size_t>(r) * hidden + q * 8);
        }
      } else {
        const bf16* src = w2 + static_cast<size_t>(h0 + (s - s1) * kKs2) * c;
        const int ldw2 = c + kPadBf16;
        const int per_row = c / 8;
        for (int i = threadIdx.x; i < kKs2 * per_row; i += kThreads) {
          const int r = i / per_row;
          const int q = i % per_row;
          cp_async16(dst + r * ldw2 + q * 8, src + static_cast<size_t>(r) * c + q * 8);
        }
      }
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void prefetch() const {
#pragma unroll
    for (int g = 0; g < kStages - 1; ++g) load_slice(g);
  }

  // The slice stream. Each step waits for slice g, then a barrier makes it
  // (and the ys / hs writes before it) visible and guarantees every warp is
  // done with slice g-1, whose stage slice g+kStages-1 then overwrites while
  // slice g is computed. Ends with os holding the f32 fc2 sums, visible to
  // every thread. Without kFc2, ends with rows [row0, row_end) of hid_out
  // [., C] holding the first C columns of the act'ed hidden (the tile's
  // row r at row0 + r).
  template <class Act>
  __device__ __forceinline__ void run(const Act& act, bf16* hid_out = nullptr,
                                      long long row0 = 0, long long row_end = 0) const {
    const int s1 = c / kKs1;
    const int spc = s1 + kFc2Slices;
    const int nslices = slices();
    const int ldw2 = c + kPadBf16;
    const int ctiles = c / 16;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wm = warp / kWN;
    const int wn = warp % kWN;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxNt];
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) wmma::fill_fragment(acc[j], 0.0f);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> z[kNj1];

    for (int g = 0; g < nslices; ++g) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      load_slice(g + kStages - 1);
      const bf16* w = ring + (g % kStages) * stage_elems;
      const int s = g % spc;
      if (s < s1) {
        // fc1: z[strip wm, this warp's chunk columns] += ys . w1 slice
        if (s == 0) {
#pragma unroll
          for (int j = 0; j < kNj1; ++j) wmma::fill_fragment(z[j], 0.0f);
        }
#pragma unroll
        for (int kk = 0; kk < kKs1; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, ys + wm * 16 * ldy + s * kKs1 + kk, ldy);
#pragma unroll
          for (int j = 0; j < kNj1; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, w + kk * ldw1 + (wn + kWN * j) * 16, ldw1);
            wmma::mma_sync(z[j], fa, fb, z[j]);
          }
        }
        if (s == s1 - 1) {
          // bias + act through the warp's staging tile into hs as bf16: the
          // chunk of h lives only here
          const int h0 = (g / spc) * kHidChunk;
#pragma unroll
          for (int j = 0; j < kNj1; ++j) {
            const int nt = wn + kWN * j;
            wmma::store_matrix_sync(scratch, z[j], kScratchLd, wmma::mem_row_major);
            __syncwarp();
            const float* bias = b1 + h0 + nt * 16;
            bf16* hrow = hs + wm * 16 * ldh + nt * 16;
#pragma unroll
            for (int e = lane; e < 256; e += 32) {
              const int r = e / 16;
              const int col = e % 16;
              const bf16 v = __float2bfloat16_rn(act(scratch[r * kScratchLd + col] + bias[col]));
              hrow[r * ldh + col] = v;
              if constexpr (!kFc2) {
                const long long row = row0 + wm * 16 + r;
                if (h0 + nt * 16 < c && row < row_end) hid_out[row * c + h0 + nt * 16 + col] = v;
              }
            }
            __syncwarp();
          }
        }
      } else if constexpr (kFc2) {
        // fc2: acc[strip wm, this warp's output columns] += h . w2 slice
        const int k0 = (s - s1) * kKs2;
#pragma unroll
        for (int kk = 0; kk < kKs2; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, hs + wm * 16 * ldh + k0 + kk, ldh);
#pragma unroll
          for (int j = 0; j < kMaxNt; ++j) {
            const int nt = wn + kWN * j;
            if (nt < ctiles) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
              wmma::load_matrix_sync(fb, w + kk * ldw2 + nt * 16, ldw2);
              wmma::mma_sync(acc[j], fa, fb, acc[j]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring becomes os
    if constexpr (kFc2) {
#pragma unroll
      for (int j = 0; j < kMaxNt; ++j) {
        const int nt = wn + kWN * j;
        if (nt < ctiles) {
          wmma::store_matrix_sync(os + wm * 16 * ldo + nt * 16, acc[j], ldo, wmma::mem_row_major);
        }
      }
      __syncthreads();
    }
  }
};

}  // namespace
