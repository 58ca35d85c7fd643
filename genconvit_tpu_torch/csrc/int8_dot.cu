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
//     Linear layout (the JAX tool's [c, hid] and [hid, c] transposed): both
//     K-major, as warpgroup MMA reads its B operand, and laid out as K1's
//     w1t and w2t. The probe times K4's two products alone: the question
//     it answers is where int8 'full' loses to K1, in its products or in
//     its quantization passes (PERF.md).
//     What bounds it on the card: h is read from device memory once, 2 (or
//     1) bytes a hidden element; the products are 4*rows*c*hid operations
//     on the tensor cores. At hid = 4c and C <= 192 the bytes are the
//     larger term, above that the operations; the int8 variant halves the
//     bytes and doubles the peak rate. chip_smoke.py prints which term sets
//     each shape's bound.
//     What the design does: one kernel template, the operand type a
//     template argument (bf16: m64n64k16 into f32; int8: m64n64k32 into
//     s32), both products on warpgroup MMA with A and B from shared memory
//     (wgmma_ss_n64, wgmma_ss_n64_s8). A work item is a 128-row tile and
//     one group of NC = 64 or 128 output columns (m1_plan: the fewest
//     columns computed); the groups of a tile are neighbouring items, so
//     the blocks that read the same rows of y and h run at the same time
//     and L2 serves all but the first. Two consumer warpgroups own 64 rows
//     each; one thread of a producer warpgroup streams every operand by TMA
//     (128-byte swizzled boxes, zero past the edges) into an mbarrier ring
//     whose stages each hold an A tile (128 rows x 128 bytes of y or of h)
//     and a B tile (NC rows x 128 bytes of w1 or w2): y is never staged
//     whole (at c = 1536 a tile's is 384 KB) and h streams in k-chunks
//     (1.5 MB a tile at hid = 4 * 1536). The consumers issue every wgmma
//     unconditionally, keep one stage's products in flight while the next
//     stage's are issued, and release each stage once its products are
//     done; each loop (the sink blocks, z, o) ends with its products done,
//     since ptxas serializes every wgmma of a kernel where one is in
//     flight across a loop's exit into another accumulator's loop (C7515;
//     1.3x slower). z[:, :c] of the group and o have their own accumulators
//     (NC / 2 registers a thread each), as the plain version sums them.
//     z's columns past c are computed, as the TPU kernel computes them: in
//     column blocks of NC over all hid columns, the blocks past the output
//     groups spread round-robin over the tile's groups, each summed into
//     one sink accumulator (z's registers, before the group's own z) that
//     only a never-taken store reads, so the compiler cannot drop those
//     products (chip_smoke.py counts the HGMMA / IGMMA instructions). The
//     epilogue adds the two sums (int8: scales them first) in registers and
//     stores bf16 pairs.
//
// The entry points return cudaGetLastError() after their launch.

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kDotThreads = 384;   // two consumer warpgroups and the producer's
constexpr int kDotRows = 128;      // rows of a work item: 64 a consumer warpgroup
constexpr int kDotSmemMax = 232448;
constexpr int kDotMisc = 256;      // 16 mbarriers

// Ring stage bytes: an A tile (128 rows x 128 bytes), then NC rows of 128
// bytes of B (NC / 64 boxes of 64 rows).
__host__ __device__ constexpr int dot_stage_bytes(int nc) { return 16384 + nc * 128; }

__host__ __device__ constexpr int dot_stages(int nc) {
  return (kDotSmemMax - 1024 - kDotMisc) / dot_stage_bytes(nc) < 8
             ? (kDotSmemMax - 1024 - kDotMisc) / dot_stage_bytes(nc)
             : 8;
}

// M1's plan at (c, hid): output columns per group (NC), ring stages and
// shared-memory bytes; cols 0 where c is not a multiple of 32 in [32, 1536]
// or hid not a multiple of 32 in [c, 4c]. NC is the one of 64 and 128
// that computes the fewest columns of o and z (groups of o, blocks of z
// over all hid columns), 128 on a tie (fewer re-reads of y and h).
struct DotPlan {
  int cols, stages, smem;
};

__host__ __device__ inline DotPlan dot_plan(int c, int hid) {
  DotPlan p = {0, 0, 0};
  if (c < 32 || c > 1536 || c % 32 != 0 || hid % 32 != 0 || hid < c || hid > 4 * c) return p;
  const int cost64 = ((c + 63) / 64 + (hid + 63) / 64) * 64;
  const int cost128 = ((c + 127) / 128 + (hid + 127) / 128) * 128;
  p.cols = cost64 < cost128 ? 64 : 128;
  p.stages = dot_stages(p.cols);
  p.smem = 1024 + p.stages * dot_stage_bytes(p.cols) + kDotMisc;
  return p;
}

// kInt8: the s8 x s8 -> s32 variant, else bf16 x bf16 -> f32. A row of a
// tile is 128 bytes: kK values, four k steps of 32 bytes.
template <bool kInt8, int NC>
struct DotLoop {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  static constexpr int kK = kInt8 ? 128 : 64;
  static constexpr int kStage = dot_stage_bytes(NC);
  static constexpr int kBoxes = NC / 64;   // B boxes of 64 rows a stage

  int stages, groups, zblocks, nkc, nkh;   // z's column blocks; k blocks of y, of h
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ DotLoop(unsigned char* smem, int c, int hid, int stages_)
      : stages(stages_), groups((c + NC - 1) / NC), zblocks((hid + NC - 1) / NC),
        nkc((c + kK - 1) / kK), nkh((hid + kK - 1) / kK), ring(smem),
        full(reinterpret_cast<uint64_t*>(smem + stages_ * kStage)), empty(full + 8) {}

  __device__ __forceinline__ int items(long long rows) const {
    return static_cast<int>((rows + kDotRows - 1) / kDotRows) * groups;
  }

  // The producer's stage: the A box at (k, row0) and the B tile of NC rows
  // from brow0 (NC / 64 boxes), completing the slot's full barrier.
  __device__ __forceinline__ void load(const CUtensorMap* amap, const CUtensorMap* bmap, int k,
                                       int row0, int brow0, uint32_t& q) const {
    const int slot = q % stages;
    mbar_wait(&empty[slot], ((q / stages) & 1) ^ 1);
    unsigned char* dst = ring + slot * kStage;
    mbar_expect_tx(&full[slot], kStage);
    tma_load_2d(dst, amap, k, row0, &full[slot]);
#pragma unroll
    for (int n = 0; n < kBoxes; ++n) {
      tma_load_2d(dst + 16384 + n * 8192, bmap, k, brow0 + 64 * n, &full[slot]);
    }
    ++q;
  }

  // One thread: every item's stages in the consumers' order (the sink
  // blocks of z, the group's z, then o).
  __device__ __forceinline__ void produce(const CUtensorMap* ym, const CUtensorMap* hm,
                                          const CUtensorMap* w1m, const CUtensorMap* w2m,
                                          long long rows) const {
    uint32_t q = 0;
    const int nitems = items(rows);
    for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
      const int row0 = (item / groups) * kDotRows;
      const int g = item % groups;
      for (int zb = groups + g; zb < zblocks; zb += groups) {
        for (int kb = 0; kb < nkc; ++kb) load(ym, w1m, kb * kK, row0, zb * NC, q);
      }
      for (int kb = 0; kb < nkc; ++kb) load(ym, w1m, kb * kK, row0, g * NC, q);
      for (int kb = 0; kb < nkh; ++kb) load(hm, w2m, kb * kK, row0, g * NC, q);
    }
  }

  __device__ __forceinline__ void release(uint32_t k) const {
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[k % stages]);
  }

  // Consumer warpgroup w, stage q: acc += A[64 w.., :] . B^T over the
  // stage's 128 bytes of k; on return every earlier stage's products are
  // done (one commit group kept in flight) and released (rel: the first
  // stage not yet released).
  __device__ __forceinline__ void step(Acc* acc, int w, uint32_t& q, uint32_t& rel) const {
    mbar_wait(&full[q % stages], (q / stages) & 1);
    wgmma_fence();
    const unsigned char* st = ring + (q % stages) * kStage;
    const uint64_t da = sw128_desc(st + w * 8192);
#pragma unroll
    for (int n = 0; n < kBoxes; ++n) {
      const uint64_t db = sw128_desc(st + 16384 + n * 8192);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if constexpr (kInt8) {
          wgmma_ss_n64_s8(acc + 32 * n, da + 2 * s, db + 2 * s, 1);
        } else {
          wgmma_ss_n64(acc + 32 * n, da + 2 * s, db + 2 * s, 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    for (; rel < q; ++rel) release(rel);
    ++q;
  }

  // Every product issued so far done and its stage released.
  __device__ __forceinline__ void drain(uint32_t q, uint32_t& rel) const {
    wgmma_wait<0>();
    for (; rel < q; ++rel) release(rel);
  }
};

template <bool kInt8, int NC>
__global__ void __launch_bounds__(kDotThreads, 1)
dots_kernel(const __grid_constant__ CUtensorMap ym, const __grid_constant__ CUtensorMap hm,
            const __grid_constant__ CUtensorMap w1m, const __grid_constant__ CUtensorMap w2m,
            const float* s1, const float* s2, bf16* out, float* sink, long long rows, int c,
            int hid, int stages) {
  using Loop = DotLoop<kInt8, NC>;
  using Acc = typename Loop::Acc;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Loop L(align1024(smem_raw), c, hid, stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&L.full[s], 1);    // the producer's one arrival, with the bytes
      mbar_init(&L.empty[s], 8);   // lane 0 of each consumer warp
    }
  }
  __syncthreads();
  if (threadIdx.x / 32 >= 8) {
    // the producer warpgroup streams; most of its registers go to the
    // consumers (2 x 128 x 224 + 128 x 56 <= 65536)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == 256) L.produce(&ym, &hm, &w1m, &w2m, rows);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int W = threadIdx.x / 128;
  const int ww = (threadIdx.x / 32) % 4;   // warp in the warpgroup: rows 16 ww..
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const int groups = L.groups;
  Acc z[NC / 2], o[NC / 2];
#pragma unroll
  for (int e = 0; e < NC / 2; ++e) z[e] = 0;
  uint32_t q = 0, rel = 0;
  const int nitems = L.items(rows);
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const long long tile0 = static_cast<long long>(item / groups) * kDotRows;
    const int g = item % groups;

    // 1. z's column blocks past the output groups into the sink (z's
    //    registers), read only by a store that is never taken
    for (int zb = groups + g; zb < L.zblocks; zb += groups) {
      for (int kb = 0; kb < L.nkc; ++kb) L.step(z, W, q, rel);
    }
    L.drain(q, rel);
    fence_regs<NC / 2>(z);
    if (sink != nullptr) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < NC / 2; ++e) s += static_cast<float>(z[e]);
      sink[static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x] = s;
    }

    // 2. the group's z over y's k, then o over h's, each loop drained
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) z[e] = o[e] = 0;
    for (int kb = 0; kb < L.nkc; ++kb) L.step(z, W, q, rel);
    L.drain(q, rel);
    for (int kb = 0; kb < L.nkh; ++kb) L.step(o, W, q, rel);
    L.drain(q, rel);
    fence_regs<NC / 2>(z);
    fence_regs<NC / 2>(o);

    // 3. epilogue: acc[32 n + 4 i + 2 h + e] is column g NC + 64 n + 8 i +
    //    2 t + e of row 64 W + 16 ww + gq + 8 h
#pragma unroll
    for (int n = 0; n < NC / 64; ++n) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = g * NC + 64 * n + 8 * i + 2 * t;
        if (col >= c) continue;
        float2 sc1 = make_float2(1.f, 1.f), sc2 = sc1;
        if constexpr (kInt8) {
          sc1 = *reinterpret_cast<const float2*>(s1 + col);
          sc2 = *reinterpret_cast<const float2*>(s2 + col);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = tile0 + 64 * W + 16 * ww + gq + 8 * h;
          if (row >= rows) continue;
          const int k = 32 * n + 4 * i + 2 * h;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (kInt8) {
              v[e] = __fadd_rn(__fmul_rn(__int2float_rn(o[k + e]), e ? sc2.y : sc2.x),
                               __fmul_rn(__int2float_rn(z[k + e]), e ? sc1.y : sc1.x));
            } else {
              v[e] = __fadd_rn(o[k + e], z[k + e]);
            }
          }
          *reinterpret_cast<bf162*>(out + row * c + col) = __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
  }
}

template <bool kInt8, int NC>
int launch_dots(const void* y, const void* h, const void* w1, const void* s1, const void* w2,
                const void* s2, void* out, long long rows, int c, int hid, const DotPlan& p,
                cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = static_cast<size_t>(p.smem);
  const int err = raise_smem_limit(dots_kernel<kInt8, NC>, smem, &smem_configured);
  if (err) return err;
  const int e = kInt8 ? 1 : 2;
  CUtensorMap ym, hm, w1m, w2m;
  int r = box_map(&ym, y, e, c, static_cast<int>(rows), 128, kDotRows);
  if (r == 0) r = box_map(&hm, h, e, hid, static_cast<int>(rows), 128, kDotRows);
  if (r == 0) r = box_map(&w1m, w1, e, c, hid, 128, 64);
  if (r == 0) r = box_map(&w2m, w2, e, hid, c, 128, 64);
  if (r) return r;
  const long long items = (rows + kDotRows - 1) / kDotRows * ((c + NC - 1) / NC);
  const long long blocks = items < sm_count() ? items : sm_count();
  dots_kernel<kInt8, NC><<<static_cast<unsigned int>(blocks), kDotThreads, smem, stream>>>(
      ym, hm, w1m, w2m, static_cast<const float*>(s1), static_cast<const float*>(s2),
      static_cast<bf16*>(out), nullptr, rows, c, hid, p.stages);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8>
int dispatch_dots(const void* y, const void* h, const void* w1, const void* s1, const void* w2,
                  const void* s2, void* out, long long rows, int c, int hid, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const DotPlan p = dot_plan(c, hid);
  if (p.cols == 0 || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.cols == 64) return launch_dots<kInt8, 64>(y, h, w1, s1, w2, s2, out, rows, c, hid, p, s);
  return launch_dots<kInt8, 128>(y, h, w1, s1, w2, s2, out, rows, c, hid, p, s);
}

}  // namespace

extern "C" {

// M1's plan at (c, hid): out = {rows per item, output columns per group,
// ring stages, shared-memory bytes}; returns 0 where M1 does not take
// (c, hid).
int gcv_m1_plan(int c, int hid, int* out) {
  const DotPlan p = dot_plan(c, hid);
  out[0] = p.cols ? kDotRows : 0;
  out[1] = p.cols;
  out[2] = p.stages;
  out[3] = p.smem;
  return p.cols != 0;
}

// M1, bf16. y [rows, c], h [rows, hid], w1 [hid, c], w2 [c, hid] bf16, out
// [rows, c] bf16; (c, hid) one gcv_m1_plan takes (the caller checks).
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
