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
// [V*F, 25088] (M = 15..120) and wq is 25088 x 12544 int8 (315 MB): at
// M = 120 the call moves 324 MB (0.097 ms at 3.35 TB/s) for 75.5 GFLOP
// (0.076 ms at the bf16 peak), and fewer rows only lower the flops.
//
// What the design does: the operands are swapped, out^T = wq . x^T, so the
// weights are wgmma's A operand, taken from registers, and x is its B
// operand in shared memory with N = the rows of x rounded up to 16, 32, 64,
// 128 or 256 (more rows tile over M). A block has three consumer warpgroups
// (two at N = 256) of 64 weight rows each and a producer warpgroup, which
// streams x while setmaxnreg moves most of its registers to the consumers.
// Each consumer thread loads 16 contiguous weight bytes of each of its two
// rows per 64-k block, 4 blocks ahead, with streaming loads, and converts
// them in registers straight into the A fragments of four k16 steps: every
// weight byte is read from device memory once and converted once for any
// M <= 256. The conversion is exact and uses no float conversion
// instruction: for a byte b, L = bf16 bits 0x4300 | (b & 0x7F) is
// 128 + (b & 0x7F) and C = 0x4300 | (b & 0x80) is 128 or 256, and L - C = b
// exactly; two bytes of one 32-bit word (bytes 0 and 2, or 1 and 3 after one
// shift) sit in the two bf16 halves, so a pair costs two LOP3 and one
// sub.bf16x2, plus half a shift: 3.5 instructions (a conversion through f32
// spends two int-to-float conversions, shifts and a pack). Taking bytes 0
// and 2 as one fragment pair permutes k inside each 64-k block; a small
// first kernel writes x in that order, rounded to bf16 and zero-padded to
// [M tiles, 64-k blocks], so the product kernel's x loads need no masks. The
// producer warpgroup streams x's 64-k blocks (L2-resident, 6 MB at M = 120)
// with cp.async into a 4-stage ring in the 128-byte-swizzled layout wgmma
// reads, shared by the consumers under full / empty mbarriers; no
// block-wide barrier in the loop. Split-K (sized from the occupancy to fill
// the SMs' last wave) writes f32 partial sums; a last small kernel adds them
// in split order and applies scale and bias (deterministic). M, K and N need
// not divide any tile: weight rows past N and k past K read as zero
// (K % 16 != 0 takes a scalar-load variant).

#include "wgmma.cuh"

namespace {

constexpr int kKB = 64;                      // k per block step
constexpr int kStages = 4;                   // x ring in shared memory
constexpr int kAhead = 4;                    // weight k-blocks in registers ahead
constexpr int kMaxNw = 256;                  // x rows per tile at most

struct W8Args {
  const bf16* xp;      // [m tiles * nw, kpad], permuted, zero-padded
  const int8_t* wq;    // [N, K]
  float* part;         // [S, M, N]
  int m, k, n, kpad;
  int kb_per_split;    // 64-k blocks per split
};

// Consumer warpgroups per block: three, and two at the widest tile (128
// accumulators a thread). A producer warpgroup follows them: it streams x,
// and setmaxnreg hands most of its registers to the consumers.
__host__ __device__ constexpr int wint8_wgs(int nw) { return nw == 256 ? 2 : 3; }
__host__ __device__ constexpr int wint8_threads(int nw) { return 128 * wint8_wgs(nw) + 128; }

// x rows per tile (wgmma N) for M rows.
__host__ __device__ constexpr int wint8_nw(int m) {
  return m <= 16 ? 16 : m <= 32 ? 32 : m <= 64 ? 64 : m <= 128 ? 128 : kMaxNw;
}

// Position inside a 64-k block of the x element that k16 step s of the
// product pairs with the weight in fragment position j (0..15): the
// fragment's pair (2t, 2t+1) is bytes 0 and 2 of the lane's word s, the
// pair (2t+8, 2t+9) bytes 1 and 3; the lane's 16 bytes start at 16t.
__device__ __forceinline__ int wint8_phys(int s, int j) {
  const int t = (j & 7) >> 1;
  return 16 * t + 4 * s + (j >> 3) + 2 * (j & 1);
}

// xp[m, 64 kb + 16 s + j] = bf16(x[m, 64 kb + phys(s, j)]), zero outside x.
template <typename T>
__global__ void __launch_bounds__(256)
wint8_prep_kernel(const T* __restrict__ x, bf16* __restrict__ xp, int m, int k, int mpad,
                  int kpad) {
  const long long q = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const int per_row = kpad / 8;
  if (q >= static_cast<long long>(mpad) * per_row) return;
  const int row = static_cast<int>(q / per_row);
  const int c8 = static_cast<int>(q % per_row);
  const int kb = c8 / 8;
  const int s = (c8 % 8) / 2;
  const int j0 = (c8 % 2) * 8;
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int kk = kb * kKB + wint8_phys(s, j0 + e);
    float f = 0.0f;
    if (row < m && kk < k) {
      if constexpr (sizeof(T) == 4) {
        f = x[static_cast<size_t>(row) * k + kk];
      } else {
        f = __bfloat162float(x[static_cast<size_t>(row) * k + kk]);
      }
    }
    v[e] = __float2bfloat16_rn(f);
  }
  *reinterpret_cast<uint4*>(xp + static_cast<size_t>(row) * kpad + c8 * 8) =
      *reinterpret_cast<const uint4*>(v);
}

// 16 weight bytes of row `wrow` from k0 on, zero past K or past N.
template <bool VEC>
__device__ __forceinline__ uint4 load_w16(const int8_t* wrow, bool row_ok, int k0, int k) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!row_ok || k0 >= k) return v;
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

// bf16x2 of the int8 bytes 0 and 2 of w (low half from byte 0), exact.
__device__ __forceinline__ uint32_t s8_even_to_bf16x2(uint32_t w) {
  const uint32_t lo = (w & 0x007F007Fu) | 0x43004300u;   // 128 + (b & 127)
  const uint32_t hi = (w & 0x00800080u) | 0x43004300u;   // 128, or 256 if b < 0
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(lo), "r"(hi));
  return d;
}

template <int NW, bool VEC>
__global__ void __launch_bounds__(wint8_threads(NW), 1)
wint8_kernel(const W8Args a) {
  constexpr int kWgs = wint8_wgs(NW);
  constexpr int kRows = 64 * kWgs;   // weight rows (outputs) per block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  constexpr int kStageBytes = NW * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int nkb_total = a.kpad / kKB;
  const int kb0 = blockIdx.y * a.kb_per_split;
  const int nkb = min(a.kb_per_split, nkb_total - kb0);
  if (nkb <= 0) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);   // every producer thread
      mbar_init(&empty[s], 4 * kWgs);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.z * NW;

  if (warp >= 4 * kWgs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // producer: x k-block i of this split -> ring stage i % kStages
    const int pt = threadIdx.x - 128 * kWgs;
    const bf16* src0 = a.xp + static_cast<size_t>(m0) * a.kpad + static_cast<size_t>(kb0) * kKB;
    for (int i = 0; i < nkb; ++i) {
      const int slot = i % kStages;
      mbar_wait(&empty[slot], ((i / kStages) & 1) ^ 1);
      unsigned char* dst = smem + slot * kStageBytes;
      for (int c = pt; c < NW * 8; c += 128) {
        const int r = c / 8;
        const int ch = c % 8;
        cp_async16(dst + r * 128 + ((ch ^ (r & 7)) << 4),
                   src0 + static_cast<size_t>(r) * a.kpad + i * kKB + ch * 8);
      }
      mbar_arrive_cp_async(&full[slot]);
    }
    cp_async_wait<0>();
    return;
  }

  // 2 x 128 x 232 + 128 x 40 and 3 x 128 x 152 + 128 x 40 registers fit the
  // block's 65536 (168 and 128 a thread at launch)
  if constexpr (NW == kMaxNw) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
  }
  // consumer: this thread's two weight rows (g and g + 8 of its warp's 16)
  const int g = lane / 4;
  const int t = lane % 4;
  const int na = blockIdx.x * kRows + warp * 16 + g;
  const int8_t* wrow[2];
  bool row_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    row_ok[j] = na + 8 * j < a.n;
    wrow[j] = a.wq + static_cast<size_t>(row_ok[j] ? na + 8 * j : 0) * a.k;
  }
  const int klane = t * 16;
  uint4 wbuf[kAhead][2];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wbuf[d][j] = d < nkb ? load_w16<VEC>(wrow[j], row_ok[j], (kb0 + d) * kKB + klane, a.k)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float acc[NW / 2];
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) acc[e] = 0.0f;

  for (int i0 = 0; i0 < nkb; i0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int i = i0 + d;
      if (i >= nkb) break;
      // A fragments of the four k16 steps: step s takes word s of each row
      uint32_t af[4][4];
      const uint32_t wa[4] = {wbuf[d][0].x, wbuf[d][0].y, wbuf[d][0].z, wbuf[d][0].w};
      const uint32_t wb[4] = {wbuf[d][1].x, wbuf[d][1].y, wbuf[d][1].z, wbuf[d][1].w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        af[s][0] = s8_even_to_bf16x2(wa[s]);
        af[s][1] = s8_even_to_bf16x2(wb[s]);
        af[s][2] = s8_even_to_bf16x2(wa[s] >> 8);
        af[s][3] = s8_even_to_bf16x2(wb[s] >> 8);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wbuf[d][j] = (i + kAhead < nkb)
                         ? load_w16<VEC>(wrow[j], row_ok[j], (kb0 + i + kAhead) * kKB + klane, a.k)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
      const int slot = i % kStages;
      mbar_wait(&full[slot], (i / kStages) & 1);
      fence_proxy_async();
      const uint64_t desc = sw128_desc(smem + slot * kStageBytes);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if constexpr (NW == 16) wgmma_rs_n16(acc, af[s], desc + 2 * s, 1);
        else if constexpr (NW == 32) wgmma_rs_n32(acc, af[s], desc + 2 * s, 1);
        else if constexpr (NW == 64) wgmma_rs_n64(acc, af[s], desc + 2 * s, 1);
        else if constexpr (NW == 128) wgmma_rs_n128(acc, af[s], desc + 2 * s, 1);
        else wgmma_rs_n256(acc, af[s], desc + 2 * s, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NW / 2>(acc);
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }

  // partial sums of this split: acc[4i + 2h + e] = out[m0 + 8i + 2t + e, na + 8h]
  float* part = a.part + static_cast<size_t>(blockIdx.y) * a.m * a.n;
#pragma unroll
  for (int i = 0; i < NW / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * i + 2 * t + e;
      if (m >= a.m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row_ok[h]) part[static_cast<size_t>(m) * a.n + na + 8 * h] = acc[4 * i + 2 * h + e];
      }
    }
  }
}

// out = (sum over splits, in split order) * scale + bias, each op rounded
// (no fused multiply-add), then bf16 or f32.
__global__ void __launch_bounds__(256)
wint8_epilogue_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                      const float* __restrict__ bias, void* out, int splits, int m, int n,
                      int out_f32) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
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

template <int NW, bool VEC>
struct Wint8Launch {
  static constexpr size_t smem = 1024 + static_cast<size_t>(kStages) * NW * 128 + 2 * kStages * 8;

  // the dynamic shared-memory limit, raised once per instantiation
  static int configure() {
    static size_t configured = 0;
    return raise_smem_limit(wint8_kernel<NW, VEC>, smem, &configured);
  }

  // resident blocks per SM
  static int blocks_per_sm() {
    int occ = 1;
    if (configure() != 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, wint8_kernel<NW, VEC>,
                                                      wint8_threads(NW), smem) != cudaSuccess ||
        occ < 1) {
      occ = 1;
    }
    return occ;
  }

  static int launch(const W8Args& a, int splits, cudaStream_t stream) {
    const int err = configure();
    if (err) return err;
    const int rows = 64 * wint8_wgs(NW);
    const dim3 grid((a.n + rows - 1) / rows, splits, (a.m + NW - 1) / NW);
    wint8_kernel<NW, VEC><<<grid, wint8_threads(NW), smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

template <class F>
auto with_tile(int m, bool vec, F f) {
  switch (wint8_nw(m)) {
    case 16: return vec ? f(Wint8Launch<16, true>{}) : f(Wint8Launch<16, false>{});
    case 32: return vec ? f(Wint8Launch<32, true>{}) : f(Wint8Launch<32, false>{});
    case 64: return vec ? f(Wint8Launch<64, true>{}) : f(Wint8Launch<64, false>{});
    case 128: return vec ? f(Wint8Launch<128, true>{}) : f(Wint8Launch<128, false>{});
    default: return vec ? f(Wint8Launch<kMaxNw, true>{}) : f(Wint8Launch<kMaxNw, false>{});
  }
}

bool wint8_vec(int k) { return k % 16 == 0; }

}  // namespace

extern "C" {

// Rows of the permuted x buffer K3 needs for M rows (M rounded up to its tile).
int gcv_wint8_x_rows(int m) {
  const int nw = wint8_nw(m);
  return (m + nw - 1) / nw * nw;
}

// Split-K ways K3 uses: the count in 1..32 (no split left empty) whose
// blocks fill the last wave of resident blocks best, with at least one full
// wave where K allows. The workspace holds splits * m * n floats.
int gcv_wint8_splits(int m, int k, int n) {
  const int nw = wint8_nw(m);
  const int rows = 64 * wint8_wgs(nw);
  const long long tiles = static_cast<long long>((n + rows - 1) / rows) * ((m + nw - 1) / nw);
  const int per_sm = with_tile(m, wint8_vec(k), [](auto l) { return decltype(l)::blocks_per_sm(); });
  const long long slots = static_cast<long long>(sm_count()) * per_sm;
  const int nkb = (k + kKB - 1) / kKB;
  int best = 1;
  double best_eff = -1.0;
  for (int s = 1; s <= 32 && s <= nkb; ++s) {
    const int per = (nkb + s - 1) / s;
    if ((nkb + per - 1) / per != s) continue;   // a split would be empty
    const long long blocks = tiles * s;
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

// K3. x [m, k] bf16 or (x_f32) f32, wq [n, k] int8, scale and bias [n] f32,
// xp [gcv_wint8_x_rows(m), 64-multiple of k] bf16 scratch, work [splits, m,
// n] f32 (splits from gcv_wint8_splits), out [m, n] bf16 or (out_f32) f32.
// Three launches: x's permuted copy, the split-K product, the epilogue.
int gcv_matmul_wint8(const void* x, const void* wq, const void* scale, const void* bias,
                     void* xp, void* work, void* out, int m, int k, int n, int x_f32,
                     int out_f32, void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nkb = (k + kKB - 1) / kKB;
  const int kpad = nkb * kKB;
  const int mpad = gcv_wint8_x_rows(m);
  const long long chunks = static_cast<long long>(mpad) * kpad / 8;
  const unsigned int pblocks = static_cast<unsigned int>((chunks + 255) / 256);
  if (x_f32) {
    wint8_prep_kernel<float><<<pblocks, 256, 0, s>>>(static_cast<const float*>(x),
                                                     static_cast<bf16*>(xp), m, k, mpad, kpad);
  } else {
    wint8_prep_kernel<bf16><<<pblocks, 256, 0, s>>>(static_cast<const bf16*>(x),
                                                    static_cast<bf16*>(xp), m, k, mpad, kpad);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int splits = gcv_wint8_splits(m, k, n);
  W8Args a;
  a.xp = static_cast<const bf16*>(xp);
  a.wq = static_cast<const int8_t*>(wq);
  a.part = static_cast<float*>(work);
  a.m = m;
  a.k = k;
  a.n = n;
  a.kpad = kpad;
  a.kb_per_split = (nkb + splits - 1) / splits;
  const bool vec = wint8_vec(k) && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  err = with_tile(m, vec, [&](auto l) { return decltype(l)::launch(a, splits, s); });
  if (err) return err;
  const long long total = static_cast<long long>(m) * n;
  wint8_epilogue_kernel<<<static_cast<unsigned int>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(work), static_cast<const float*>(scale),
      static_cast<const float*>(bias), out, splits, m, n, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
