// Hand-written Hopper (sm_90a) probe kernels: the two matrix products of a
// ConvNeXt block tail, in bf16 and in int8, with a plain C interface loaded
// through ctypes (genconvit_tpu_torch/ops/cuda/int8_dot.py). No PyTorch
// headers.
//
// M1  gcv_dots_bf16 / gcv_dots_int8  replace the Pallas kernels
//     dots_bf16_kernel and dots_int8_kernel of tools/microbench_int8_dot.py
//     (built by its build(); pallas_call at :96). Per row r of [rows, c]:
//
//       bf16:  out = bf16(o + z[:, :c]),  z = y . w1 (f32 sums, all hid
//              columns), o = h . w2 (f32 sums)
//       int8:  out = bf16(f32(o) * s2 + f32(z[:, :c]) * s1[:c]),  z, o
//              int32 sums of the int8 products; the scales apply in f32
//              after the integer sums, as at :62-66
//
//     y [rows, c], h [rows, hid]; w1 [hid, c] and w2 [c, hid] in the torch
//     Linear layout (the JAX tool's [c, hid] and [hid, c] transposed), so
//     that each B fragment is one 32-bit load of consecutive k.
//     The probe times K4's two dots alone: the question it answers is
//     whether int8 'full' loses to K1 at C=768 in its products or in its
//     quantization passes (PERF.md).
//     What bounds it on the card: h is read from device memory once, 2 (or
//     1) bytes a hidden element; the products are 4*rows*c*hid operations
//     on the tensor cores. At hid = 4c and C <= 192 the bytes are the
//     larger term, above that the operations; the int8 variant halves the
//     bytes and doubles the peak rate. chip_smoke.py prints which term sets
//     each shape's bound.
//     What the design does: a thread block owns BM = 64/32/16 rows (C up to
//     192/384/768, K1's and K4's row tile) and stages their y and h rows in
//     shared memory by cp.async, once; its 8 warps split the tile into
//     16-row strips x column tiles. Each warp runs mma.sync (m16n8k16 bf16
//     -> f32, or m16n8k32 s8 -> s32) with A fragments from shared memory and
//     B fragments straight from the L2-resident weights, as K4 reads them
//     per row tile. All hid columns of z are computed, as the TPU kernel
//     computes them, though only z[:, :c] reaches the output: the columns
//     past c go into one sink accumulator per warp that is stored only when
//     the caller passes a sink pointer (never), so the compiler cannot drop
//     those products (chip_smoke.py counts the HMMA/IMMA instructions).
//     z and o have their own accumulators, as the plain version sums them.
//     Nothing is pipelined: a simple kernel that is right; making it fast
//     is not its purpose.
//
// The entry points return cudaGetLastError() after their launch.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kDotThreads = 256;
constexpr int kDotWarps = kDotThreads / 32;
constexpr int kMaxOutTiles = 12;   // n8 output tiles per warp: C/8/(warp columns) <= 12

__host__ __device__ constexpr int dot_row_tile(int c) { return c <= 192 ? 64 : c <= 384 ? 32 : 16; }

// Shared-memory row stride in 32-bit words: the row's bytes plus 16 bytes
// of padding, which spreads the 8 rows of a fragment over the banks.
__host__ __device__ __forceinline__ int smem_words(int cols, int elem_bytes) {
  return (cols * elem_bytes + 16) / 4;
}

__host__ __device__ __forceinline__ size_t dot_smem(int bm, int c, int hid, int elem_bytes) {
  return align128(static_cast<size_t>(bm) * smem_words(c, elem_bytes) * 4) +
         static_cast<size_t>(bm) * smem_words(hid, elem_bytes) * 4;
}

// Rows [row0, row0 + BM) of src [rows, cols] into shared memory (row stride
// ld words), zeros past the last row.
template <int BM>
__device__ __forceinline__ void stage_rows(uint32_t* dst, int ld, const unsigned char* src,
                                           long long row0, long long rows, int row_bytes) {
  const int chunks = row_bytes / 16;
  for (int i = threadIdx.x; i < BM * chunks; i += kDotThreads) {
    const int r = i / chunks;
    const int q = i % chunks;
    const bool live = row0 + r < rows;
    const unsigned char* s = src + (live ? (row0 + r) * row_bytes + q * 16 : 0);
    cp_async16_zfill(dst + r * ld + q * 4, s, live ? 16 : 0);
  }
}

// kInt8: the s8 x s8 -> s32 variant, else bf16 x bf16 -> f32. One mma's k
// covers 8 words of a row in both (16 bf16 or 32 int8 values).
template <bool kInt8, int BM>
__global__ void __launch_bounds__(kDotThreads, 1)
dots_kernel(const unsigned char* y, const unsigned char* h, const uint32_t* w1,
            const float* s1, const uint32_t* w2, const float* s2, bf16* out, float* sink,
            long long rows, int c, int hid) {
  typedef typename std::conditional<kInt8, int, float>::type Acc;
  constexpr int kElem = kInt8 ? 1 : 2;
  constexpr int kWM = BM / 16;
  constexpr int kWN = kDotWarps / kWM;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = smem_words(c, kElem);
  const int ldh = smem_words(hid, kElem);
  uint32_t* ys = reinterpret_cast<uint32_t*>(smem);
  uint32_t* hs = reinterpret_cast<uint32_t*>(smem + align128(static_cast<size_t>(BM) * ldy * 4));
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  stage_rows<BM>(ys, ldy, y, row0, rows, c * kElem);
  stage_rows<BM>(hs, ldh, h, row0, rows, hid * kElem);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp / kWN;
  const int wn = warp % kWN;
  const int ct = c / 8;        // n8 tiles of the output (and of the used z)
  const int ht = hid / 8;      // n8 tiles of z
  const int cw = c * kElem / 4;     // words per row of y and of w1
  const int hw = hid * kElem / 4;   // words per row of h and of w2

  auto mma = [](Acc* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                uint32_t b1) {
    if constexpr (kInt8) {
      mma_s8_16832(d, a0, a1, a2, a3, b0, b1);
    } else {
      mma_bf16_16816(d, a0, a1, a2, a3, b0, b1);
    }
  };

  Acc zacc[kMaxOutTiles][4], oacc[kMaxOutTiles][4], zsink[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < kMaxOutTiles; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) zacc[i][e] = oacc[i][e] = 0;
  }

  // z = y . w1 over all hid columns
  const uint32_t* ya = ys + (wm * 16 + g) * ldy + t;
  for (int kw = 0; kw < cw; kw += 8) {
    const uint32_t a0 = ya[kw], a1 = ya[8 * ldy + kw], a2 = ya[kw + 4], a3 = ya[8 * ldy + kw + 4];
#pragma unroll
    for (int i = 0; i < kMaxOutTiles; ++i) {
      const int j = wn + kWN * i;
      if (j < ct) {
        const uint32_t* b = w1 + static_cast<size_t>(j * 8 + g) * cw + kw + t;
        mma(zacc[i], a0, a1, a2, a3, __ldg(b), __ldg(b + 4));
      }
    }
    for (int j = ct + wn; j < ht; j += kWN) {
      const uint32_t* b = w1 + static_cast<size_t>(j * 8 + g) * cw + kw + t;
      mma(zsink, a0, a1, a2, a3, __ldg(b), __ldg(b + 4));
    }
  }
  // o = h . w2
  const uint32_t* ha = hs + (wm * 16 + g) * ldh + t;
  for (int kw = 0; kw < hw; kw += 8) {
    const uint32_t a0 = ha[kw], a1 = ha[8 * ldh + kw], a2 = ha[kw + 4], a3 = ha[8 * ldh + kw + 4];
#pragma unroll
    for (int i = 0; i < kMaxOutTiles; ++i) {
      const int j = wn + kWN * i;
      if (j < ct) {
        const uint32_t* b = w2 + static_cast<size_t>(j * 8 + g) * hw + kw + t;
        mma(oacc[i], a0, a1, a2, a3, __ldg(b), __ldg(b + 4));
      }
    }
  }

  // epilogue: d0, d1 at (row g, columns 2t, 2t+1), d2, d3 at row g+8
#pragma unroll
  for (int i = 0; i < kMaxOutTiles; ++i) {
    const int j = wn + kWN * i;
    if (j >= ct) continue;
    const int col = j * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = row0 + wm * 16 + g + 8 * half;
      if (row >= rows) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const Acc zi = zacc[i][2 * half + e], oi = oacc[i][2 * half + e];
        if constexpr (kInt8) {
          v[e] = __fadd_rn(__fmul_rn(__int2float_rn(oi), s2[col + e]),
                           __fmul_rn(__int2float_rn(zi), s1[col + e]));
        } else {
          v[e] = __fadd_rn(oi, zi);
        }
      }
      *reinterpret_cast<bf162*>(out + row * c + col) = __floats2bfloat162_rn(v[0], v[1]);
    }
  }
  if (sink != nullptr) {   // never taken: keeps the products of z[:, c:] live
    sink[static_cast<size_t>(blockIdx.x) * kDotThreads + threadIdx.x] =
        static_cast<float>(zsink[0]) + static_cast<float>(zsink[1]) +
        static_cast<float>(zsink[2]) + static_cast<float>(zsink[3]);
  }
}

template <bool kInt8, int BM>
int launch_dots(const void* y, const void* h, const void* w1, const void* s1, const void* w2,
                const void* s2, void* out, long long rows, int c, int hid, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = dot_smem(BM, c, hid, kInt8 ? 1 : 2);
  const int err = raise_smem_limit(dots_kernel<kInt8, BM>, smem, &smem_configured);
  if (err) return err;
  const long long blocks = (rows + BM - 1) / BM;
  dots_kernel<kInt8, BM><<<static_cast<unsigned int>(blocks), kDotThreads, smem, stream>>>(
      static_cast<const unsigned char*>(y), static_cast<const unsigned char*>(h),
      static_cast<const uint32_t*>(w1), static_cast<const float*>(s1),
      static_cast<const uint32_t*>(w2), static_cast<const float*>(s2), static_cast<bf16*>(out),
      nullptr, rows, c, hid);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8>
int dispatch_dots(const void* y, const void* h, const void* w1, const void* s1, const void* w2,
                  const void* s2, void* out, long long rows, int c, int hid, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dot_row_tile(c)) {
    case 64: return launch_dots<kInt8, 64>(y, h, w1, s1, w2, s2, out, rows, c, hid, s);
    case 32: return launch_dots<kInt8, 32>(y, h, w1, s1, w2, s2, out, rows, c, hid, s);
    default: return launch_dots<kInt8, 16>(y, h, w1, s1, w2, s2, out, rows, c, hid, s);
  }
}

}  // namespace

extern "C" {

// M1, bf16. y [rows, c], h [rows, hid], w1 [hid, c], w2 [c, hid] bf16, out
// [rows, c] bf16; c a multiple of 32 and at most 768, hid a multiple of 32
// in [c, 4c] (the caller checks).
int gcv_dots_bf16(const void* y, const void* h, const void* w1, const void* w2, void* out,
                  long long rows, int c, int hid, void* stream) {
  return dispatch_dots<false>(y, h, w1, nullptr, w2, nullptr, out, rows, c, hid, stream);
}

// M1, int8. yq, hq, w1q, w2q int8 in the same layouts; s1 [hid], s2 [c] f32.
int gcv_dots_int8(const void* yq, const void* hq, const void* w1q, const void* s1,
                  const void* w2q, const void* s2, void* out, long long rows, int c, int hid,
                  void* stream) {
  return dispatch_dots<true>(yq, hq, w1q, s1, w2q, s2, out, rows, c, hid, stream);
}

}  // extern "C"
