// K3 gcv_matmul_wint8: the weight-only int8 matmul of the VAE latent head,
// a hand-written Hopper (sm_90a) kernel with a plain C interface loaded
// through ctypes (genconvit_tpu_torch/ops/cuda/int8_matmul.py).
//
// Replaces the Pallas kernel _kernel of genconvit_tpu/ops/pallas/
// int8_matmul.py (entry matmul_wint8):
//     out[m, n] = (sum_k bf16(x[m, k]) * bf16(wq[n, k])) * scale[n] + bias[n]
// with an f32 sum, written as bf16 or f32 (the caller's x dtype). wq keeps
// the torch Linear layout [N, K] (K contiguous), int8 with per-output
// scales; the int8 -> bf16 conversion is exact.
//
// What bounds it on the card: the weight read. On the scoring path x is
// [V*F, 25088] bf16 (M = 15..120) and wq is 25088 x 12544 int8 (315 MB):
// at M = 120 the call moves 324 MB (0.097 ms at 3.35 TB/s) for 75.5 GFLOP
// (0.076 ms at the bf16 peak), and fewer rows only lower the flops.
//
// What the design does: every weight byte is read from device memory
// exactly once, straight into the registers of the one warp that uses it.
// A block owns 128 output columns (16 per warp) and one of S slices of K
// (split-K, so that 12544 / 128 = 98 column strips still give every SM
// blocks to stream with); each lane loads 16 contiguous weight bytes of its
// column per 64-k block, 4 blocks ahead of the tensor cores (streaming
// loads, so the weights do not evict x from L2). The k order inside a
// 64-k block is permuted so that those 16 bytes are exactly the lane's
// B fragments of four m16n8k16 steps, and x's A fragments are read with
// the same permutation. x (at most 6 MB at M = 120, L2-resident) goes
// through a 4-stage cp.async ring in shared memory shared by the 8 warps.
// A block holds up to 64 rows; at M = 120 two blocks, launched side by
// side, share each weight strip, the second reading it from L2. int8 converts to bf16 in registers and the
// products run on mma.sync m16n8k16 (bf16 in, f32 sum). The S partial
// sums go to an f32 workspace; a second, small kernel adds them in a fixed
// order and applies scale and bias (deterministic). M, K and N need not
// divide any tile: rows, columns and k past the ends are zero-filled or
// masked; K % 16 != 0 takes a scalar-load variant.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 16 * kWarps;   // output columns per block
constexpr int kKB = 64;            // k per block step
constexpr int kStages = 4;         // x ring in shared memory
constexpr int kAhead = 4;          // weight k-blocks in registers ahead
constexpr int kXld = kKB + 8;      // x row stride in shared memory (bf16)

struct W8Args {
  const bf16* x;       // [M, K]
  const int8_t* wq;    // [N, K]
  float* part;         // [S, M, N]
  int m, k, n;
  int kb_per_split;    // 64-k blocks per split
};

__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t w, int byte) {
  const float lo = static_cast<float>(static_cast<int8_t>((w >> (8 * byte)) & 0xffu));
  const float hi = static_cast<float>(static_cast<int8_t>((w >> (8 * byte + 8)) & 0xffu));
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 weight bytes of column row `wrow` from k0 on, zero past K or past N.
template <bool VEC>
__device__ __forceinline__ uint4 load_w16(const int8_t* wrow, bool col_ok, int k0, int k) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!col_ok || k0 >= k) return v;
  if (VEC) return __ldcs(reinterpret_cast<const uint4*>(wrow + k0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (k0 + e < k) {
      w[e / 4] |= (static_cast<uint32_t>(static_cast<uint8_t>(wrow[k0 + e]))) << (8 * (e % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
wint8_kernel(const W8Args a) {
  constexpr int kRows = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = blockIdx.x * kRows;
  const int nkb_total = (a.k + kKB - 1) / kKB;
  const int kb0 = blockIdx.y * a.kb_per_split;
  const int nkb = min(a.kb_per_split, nkb_total - kb0);
  if (nkb <= 0) return;

  // x k-block i of this split -> ring stage i % kStages, one copy group
  auto load_x = [&](int i) {
    if (i < nkb) {
      bf16* dst = xs + (i % kStages) * kRows * kXld;
      const int kbase = (kb0 + i) * kKB;
      if (VEC) {
        for (int c = threadIdx.x; c < kRows * (kKB / 8); c += kThreads) {
          const int r = c / (kKB / 8);
          const int q = c % (kKB / 8);
          const int row = m0 + r;
          const int kk = kbase + q * 8;
          const bool ok = row < a.m && kk < a.k;
          const bf16* src = ok ? a.x + static_cast<size_t>(row) * a.k + kk : a.x;
          cp_async16_zfill(dst + r * kXld + q * 8, src, ok ? 16 : 0);
        }
      } else {
        for (int c = threadIdx.x; c < kRows * kKB; c += kThreads) {
          const int r = c / kKB;
          const int q = c % kKB;
          const int row = m0 + r;
          const int kk = kbase + q;
          dst[r * kXld + q] = (row < a.m && kk < a.k)
                                  ? a.x[static_cast<size_t>(row) * a.k + kk]
                                  : __float2bfloat16_rn(0.0f);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_x(i);

  // this lane's two weight columns (one per n8 tile) and its k offset
  const int ncol0 = blockIdx.z * kBN + warp * 16 + g;
  const int8_t* wrow[2];
  bool col_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = ncol0 + 8 * j;
    col_ok[j] = n < a.n;
    wrow[j] = a.wq + static_cast<size_t>(col_ok[j] ? n : 0) * a.k;
  }
  const int klane = t * 16;
  uint4 wbuf[kAhead][2];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wbuf[d][j] = d < nkb ? load_w16<VEC>(wrow[j], col_ok[j], (kb0 + d) * kKB + klane, a.k)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;

  for (int i0 = 0; i0 < nkb; i0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int i = i0 + d;
      if (i >= nkb) break;
      cp_async_wait<kStages - 2>();
      __syncthreads();
      load_x(i + kStages - 1);
      const bf16* xst = xs + (i % kStages) * kRows * kXld;
      // B fragments of the four k16 steps: step s uses word s of the
      // lane's 16 bytes, bytes 0-1 as b0 and bytes 2-3 as b1, i.e. the
      // lane's k positions 2t, 2t+1 | 2t+8, 2t+9 map to physical k
      // 16t + 4s + {0, 1} | {2, 3}; A reads x with the same map.
      uint32_t b[4][2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t w4[4] = {wbuf[d][j].x, wbuf[d][j].y, wbuf[d][j].z, wbuf[d][j].w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          b[s][j][0] = s8x2_to_bf16x2(w4[s], 0);
          b[s][j][1] = s8x2_to_bf16x2(w4[s], 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wbuf[d][j] = (i + kAhead < nkb)
                         ? load_w16<VEC>(wrow[j], col_ok[j], (kb0 + i + kAhead) * kKB + klane, a.k)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // 16 bf16 of rows g and g+8 at k 16t..16t+15: 8 words each
        const uint4* lo = reinterpret_cast<const uint4*>(xst + (mt * 16 + g) * kXld + klane);
        const uint4* hi = reinterpret_cast<const uint4*>(xst + (mt * 16 + g + 8) * kXld + klane);
        const uint4 l0 = lo[0], l1 = lo[1], h0 = hi[0], h1 = hi[1];
        const uint32_t xl[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        const uint32_t xh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_bf16_16816(acc[mt][j], xl[2 * s], xh[2 * s], xl[2 * s + 1], xh[2 * s + 1],
                           b[s][j][0], b[s][j][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // partial sums of this split: d0, d1 (row g, columns 2t, 2t+1), d2, d3
  // (row g+8)
  float* part = a.part + static_cast<size_t>(blockIdx.y) * a.m * a.n;
  const int nb = blockIdx.z * kBN + warp * 16 + 2 * t;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mt * 16 + g + 8 * h;
      if (row >= a.m) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nb + 8 * j + e;
          if (n < a.n) part[static_cast<size_t>(row) * a.n + n] = acc[mt][j][2 * h + e];
        }
      }
    }
  }
}

// out = (sum over splits, in split order) * scale + bias, each op rounded
// (no fused multiply-add), then bf16 or f32.
__global__ void __launch_bounds__(kThreads)
wint8_epilogue_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                      const float* __restrict__ bias, void* out, int splits, int m, int n,
                      int out_f32) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long total = static_cast<long long>(m) * n;
  if (i >= total) return;
  const int col = static_cast<int>(i % n);
  float z = part[i];
  for (int s = 1; s < splits; ++s) z = __fadd_rn(z, part[s * total + i]);
  const float v = __fadd_rn(__fmul_rn(z, scale[col]), bias[col]);
  if (out_f32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
  }
}

template <int MT, bool VEC>
int launch_wint8(const W8Args& a, int splits, cudaStream_t stream) {
  static size_t smem_configured = 0;
  const size_t smem = static_cast<size_t>(kStages) * 16 * MT * kXld * sizeof(bf16);
  if (smem > smem_configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wint8_kernel<MT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_configured = smem;
  }
  // row tiles fastest: the blocks that stream the same weights run side by
  // side, so all but the first read them from L2
  const dim3 grid((a.m + 16 * MT - 1) / (16 * MT), splits, (a.n + kBN - 1) / kBN);
  wint8_kernel<MT, VEC><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_wint8_rows(const W8Args& a, int mt, int splits, cudaStream_t s) {
  switch (mt) {
    case 1: return launch_wint8<1, VEC>(a, splits, s);
    case 2: return launch_wint8<2, VEC>(a, splits, s);
    default: return launch_wint8<4, VEC>(a, splits, s);
  }
}

}  // namespace

extern "C" {

// Row tiles (m16 tiles per block) K3 uses for M rows: 1, 2 or 4; more
// rows take more blocks.
int gcv_wint8_row_tiles(int m) {
  const int need = (m + 15) / 16;
  return need <= 1 ? 1 : need <= 2 ? 2 : 4;
}

// Split-K ways K3 uses: the count in 1..16 (no split left empty) whose
// blocks fill the last wave best (132 SMs, 2 blocks per SM), with at least
// one full wave where K allows. The
// workspace holds splits * m * n floats.
int gcv_wint8_splits(int m, int k, int n) {
  const int mt = gcv_wint8_row_tiles(m);
  const int strips = ((n + kBN - 1) / kBN) * ((m + 16 * mt - 1) / (16 * mt));
  const int slots = 132 * 2;
  const int nkb = (k + kKB - 1) / kKB;
  int best = 1;
  double best_eff = -1.0;
  for (int s = 1; s <= 16 && s <= nkb; ++s) {
    const int per = (nkb + s - 1) / s;
    if ((nkb + per - 1) / per != s) continue;   // a split would be empty
    const long long blocks = static_cast<long long>(strips) * s;
    const long long waves = (blocks + slots - 1) / slots;
    double eff = static_cast<double>(blocks) / static_cast<double>(waves * slots);
    if (blocks < slots) eff *= 0.5;              // the card is not yet full
    if (eff > best_eff + 1e-9) {
      best_eff = eff;
      best = s;
    }
  }
  return best;
}

// K3. x [m, k] bf16, wq [n, k] int8, scale and bias [n] f32, work
// [splits, m, n] f32 (splits from gcv_wint8_splits), out [m, n] bf16 or
// (out_f32) f32. Two launches: the split-K product, then the epilogue.
int gcv_matmul_wint8(const void* x, const void* wq, const void* scale, const void* bias,
                     void* work, void* out, int m, int k, int n, int out_f32,
                     void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = gcv_wint8_splits(m, k, n);
  const int nkb = (k + kKB - 1) / kKB;
  W8Args a;
  a.x = static_cast<const bf16*>(x);
  a.wq = static_cast<const int8_t*>(wq);
  a.part = static_cast<float*>(work);
  a.m = m;
  a.k = k;
  a.n = n;
  a.kb_per_split = (nkb + splits - 1) / splits;
  const bool vec = k % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const int mt = gcv_wint8_row_tiles(m);
  const int err = vec ? launch_wint8_rows<true>(a, mt, splits, s)
                      : launch_wint8_rows<false>(a, mt, splits, s);
  if (err) return err;
  const long long total = static_cast<long long>(m) * n;
  wint8_epilogue_kernel<<<static_cast<unsigned int>((total + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(static_cast<const float*>(work),
                                            static_cast<const float*>(scale),
                                            static_cast<const float*>(bias), out, splits, m, n,
                                            out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
