// Hand-written Hopper (sm_90a) kernel for Swin's windowed multi-head
// attention, with a plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/window_attn.py). No PyTorch headers.
//
// K7  gcv_window_attention  replaces the Pallas kernels _attn_kernel and
//     _attn_kernel_nomask of genconvit_tpu/ops/pallas/window_attn.py (entry
//     window_attention_pallas): per window-head,
//       out = bf16(bf16(softmax(q . k^T * hd^-1/2 + bias[head] (+ mask[win]))) . v)
//     with f32 scores and an f32 sum of the second product; win = window %
//     nw. It reads the qkv linear's output [B, L, 3, heads, hd] directly and
//     writes [B, L, heads, hd], the proj linear's input, so the two permute
//     copies around the JAX package's kernel are not made.
//     What bounds it on the card: the bytes. Every window-head reads q, k,
//     v (3 * L * hd * 2 bytes) and writes its output once; its two products
//     (4 * L^2 * hd operations) are far below the tensor cores' rate for
//     those bytes (about 19 operations a byte at L = 49, hd = 32, against
//     the card's ~295), and the softmax's ~8 f32 operations a score are
//     below the f32 cores' rate too. So the kernel must keep enough bytes
//     in flight, and spend few instructions per byte around the products;
//     in this design the second binds (with its copies skipped the kernel
//     runs no faster).
//     What the design does:
//     - A work item is one window x a group of G heads, with G * hd >= 64
//       where the heads allow it, so each token's q, k and v slices are at
//       least 128 contiguous bytes (swin_tiny's first stage: the whole
//       window, 49 x 576 contiguous bytes). Blocks are persistent, one per
//       SM; a block keeps one head group for its life and walks the windows.
//     - The block's consumer warps come in teams of G * S warps (S =
//       ceil(L / 16) query strips): warp (h, s) of a team computes query
//       strip s of head h of every item its team takes; teams take items in
//       turn. Each team has its own ring of stages in shared memory: one
//       thread of the team asks TMA for an item's q, k and v (one 2-D box of
//       [L tokens, hd] per tensor and head over the [B L, 3C] view, swizzled
//       by hd * 2 bytes so that ldmatrix reads are free of bank conflicts)
//       and, under a mask, for a bulk copy of the window's mask in the order
//       of the MMA accumulator fragments (the wrapper lays the masks out so,
//       one gather a launch), all on the stage's full mbarrier; it asks for
//       the item `stages` ahead once the team has left the stage (a named
//       barrier of the team). No thread computes addresses for the copies.
//     - The head group's bias (times log2 e, -inf on the keys >= L) sits in
//       shared memory once for the block's life, in the same fragment order:
//       a lane reads the 4 values of its scores of 8 keys, of bias and of
//       mask, with one 16-byte load each (the mask as it lies, [L][L], read
//       by scalars, had 4-way bank conflicts).
//     - q and k fragments by ldmatrix, v's B fragments by ldmatrix.trans
//       from v as it arrived (no transpose). Scores with mma.sync m16n8k16
//       (bf16 in, f32 sum) over ceil(L / 8) key tiles (56 keys at L = 49);
//       scale, log2 e and bias in one fused multiply-add, the mask in a
//       second; row max and sum across the four lanes of a row by shuffles;
//       exp as ex2 of the difference; one reciprocal per row sum. p stays in
//       registers: the score accumulators, packed to bf16 pairs, are p . v's
//       A fragments (ceil(L / 16) key steps).
//     - The output goes through the warp's own q tile in shared memory and
//       leaves as 16-byte stores, only the strip's valid rows.
//     Padding: the last strip of L = 49 holds one valid row; its products
//     run (an m16 tile cannot be cut) but only that row is stored.
//
// The entry points return cudaGetLastError() after their launch.

#include <math.h>

#include "wgmma.cuh"   // mbarriers, sm_count

namespace {

constexpr int kMaxL = 64;           // tokens per window
constexpr int kMaxWarps = 16;       // warps of a block
constexpr int kMaxTeams = 8;        // named barriers 1..8
constexpr int kMaxStages = 3;       // ring stages of a team
constexpr int kAttnThreads = 32 * kMaxWarps;
constexpr int kSmemLimit = 232448;  // shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

struct K7Plan {
  int group;    // G heads per work item
  int strips;   // S 16-row query strips
  int teams;    // teams of G * S warps
  int stages;   // ring stages of each team
  int smem;     // dynamic shared memory, bytes
  int threads;  // 32 * teams * G * S
  int blocks;   // (heads / G) * blocks per head group
};

// The head group's bias in fragment order [G][S][ceil(L / 8)][32 lanes][4]
// f32, its area rounded to 1024 bytes (the ring after it keeps TMA's
// swizzle atoms aligned).
__host__ __device__ inline int k7_bias_bytes(int group, int strips, int l) {
  return (group * strips * ((l + 7) / 8) * 512 + 1023) & ~1023;
}

// One stage: the q, k, v tiles [3][G][16 S rows][hd] bf16 (each row of hd
// * 2 bytes swizzled by that span), then under a mask the window's mask in
// fragment order [S][ceil(L / 8)][32 lanes][4] f32.
__host__ __device__ inline int k7_stage_bytes(int group, int strips, int hd, int l, bool masked) {
  const int tiles = 3 * group * 16 * strips * hd * 2;
  const int mask = masked ? strips * ((l + 7) / 8) * 512 : 0;
  return (tiles + mask + 1023) & ~1023;
}

// Blocks of a launch with `groups` head groups: sms / groups per group (at
// least 1, at most the windows), one per SM.
__host__ inline long long k7_sms_used(int groups, long long windows, int sms) {
  long long per = sms / groups;
  if (per < 1) per = 1;
  if (per > windows) per = windows;
  return groups * per;
}

// Shared memory for the rings: the limit less the alignment slack, the bias
// and the barriers.
__host__ inline int k7_ring_bytes(int group, int strips, int l) {
  return kSmemLimit - 1024 - k7_bias_bytes(group, strips, l) - 256;
}

// A group of G heads fits a team of G * S warps and two stages of its items.
__host__ inline bool k7_group_fits(int group, int strips, int hd, int l, bool masked) {
  return group * strips <= kMaxWarps &&
         k7_ring_bytes(group, strips, l) >= 2 * k7_stage_bytes(group, strips, hd, l, masked);
}

// The plan of one launch (mirrored in window_attn.py k7_plan). G: of the
// divisors of heads that fit (k7_group_fits) with G * hd >= 64, the one
// whose blocks fill the most SMs (the smallest of equals); where there is
// none, the largest divisor that fits. Teams fill kMaxWarps (at
// most kMaxTeams), fewer where shared memory cannot give each two stages;
// each team's ring holds up to kMaxStages.
__host__ inline K7Plan k7_plan(int l, int heads, int hd, bool masked, long long windows,
                               int sms) {
  K7Plan p = {0, 0, 0, 0, 0, 0, 0};
  if (l < 1 || l > kMaxL || heads < 1 || windows < 1 || sms < 1 ||
      (hd != 16 && hd != 32 && hd != 64)) {
    return p;
  }
  const int s = (l + 15) / 16;
  int g = 0;
  long long best = 0;
  for (int d = 1; d <= heads; ++d) {
    if (heads % d == 0 && k7_group_fits(d, s, hd, l, masked) && d * hd >= 64) {
      const long long fill = k7_sms_used(heads / d, windows, sms);
      if (fill > best) { g = d; best = fill; }
    }
  }
  for (int d = heads; d >= 1 && g == 0; --d) {
    if (heads % d == 0 && k7_group_fits(d, s, hd, l, masked)) g = d;
  }
  if (g == 0) return p;
  const int stage = k7_stage_bytes(g, s, hd, l, masked);
  const int avail = k7_ring_bytes(g, s, l);
  int teams = kMaxWarps / (g * s);
  if (teams > kMaxTeams) teams = kMaxTeams;
  while (teams > 1 && avail / (teams * stage) < 2) --teams;
  int stages = avail / (teams * stage);
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 1) return p;
  const int groups = heads / g;
  p.group = g;
  p.strips = s;
  p.teams = teams;
  p.stages = stages;
  p.smem = 1024 + k7_bias_bytes(g, s, l) + teams * stages * stage + 256;
  p.threads = 32 * teams * g * s;
  p.blocks = static_cast<int>(k7_sms_used(groups, windows, sms));
  return p;
}

struct AttnArgs {
  const bf16* qkv;
  const float* bias;
  const float* mask;
  bf16* out;
  long long windows;
  int l, heads, nw;
  float scale;
  int group, strips, teams, stages, stage_bytes;
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const bf162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `chunk` of row r in a tile of rows of HD bf16,
// as TMA swizzles it by the row's span (32, 64 or 128 bytes): the chunk
// index XOR the row's bits above it (CUTLASS Swizzle<log2(HD / 8), 4, 3>).
template <int HD>
__device__ __forceinline__ int tile_off(int r, int chunk) {
  constexpr int kC = HD / 8;
  return r * HD * 2 + (((chunk ^ (r / (8 / kC))) & (kC - 1)) << 4);
}

// A team's one thread: item i of this block (window w0 + i * per) into
// the team's stage `slot`: q, k, v of the G heads by TMA and, under a mask,
// the window's mask fragments by a bulk copy, all on the stage's full
// barrier.
template <int HD>
__device__ __forceinline__ void load_item(const AttnArgs& a, const CUtensorMap* map,
                                          unsigned char* st, uint64_t* full, int hg, int win) {
  const int g = a.group, l = a.l;
  const int tile = 16 * a.strips * HD * 2;
  const int tiles = 3 * g * tile;
  const int mfloats = a.strips * ((l + 7) / 8) * 128;
  uint32_t bytes = static_cast<uint32_t>(3 * g * l * HD * 2);
  if (a.mask != nullptr) bytes += 4 * mfloats;
  mbar_expect_tx(full, bytes);
  const int c = a.heads * HD;
  const int row = win * l;
  for (int t = 0; t < 3; ++t) {
    for (int h = 0; h < g; ++h) {
      tma_load_2d(st + (t * g + h) * tile, map, t * c + (hg * g + h) * HD, row, full);
    }
  }
  if (a.mask != nullptr) {
    bulk_load(st + tiles, a.mask + (win % a.nw) * mfloats, static_cast<uint32_t>(4 * mfloats),
              full);
  }
}

// NT: key tiles of 8 fixed at compile time, or 0 for ceil(L / 8) at run time.
template <int HD, bool MASKED, int NT>
__global__ void __launch_bounds__(kAttnThreads, 1)
window_attn_kernel(const AttnArgs a, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int g = a.group, l = a.l;
  const int nt_n = NT > 0 ? NT : (l + 7) / 8;
  const int ns = NT > 0 ? (NT + 1) / 2 : a.strips;
  const int ks_n = (nt_n + 1) / 2;
  const int tile = 16 * ns * HD * 2;            // bytes of one head's q (k, v) tile
  const int tiles = 3 * g * tile;
  float* sbias = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + k7_bias_bytes(g, ns, l);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.teams * a.stages * a.stage_bytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int team_warps = g * ns;
  const int team = warp / team_warps;
  const int h = (warp % team_warps) / ns, s = warp % ns;
  const int groups = a.heads / g;
  const int hg = blockIdx.x % groups;
  const long long per = gridDim.x / groups;
  const long long w0 = blockIdx.x / groups;

  // rows >= L of the rings' k and v tiles zeroed once (TMA writes rows < L):
  // the products read them, and 0 * NaN would not be 0 (rows >= L of q only
  // reach rows of the output that are not stored); the group's bias x log2 e
  // in fragment order, -inf on keys >= L
  const int pad = (16 * ns - l) * HD * 2 / 16;   // 16-byte chunks past row L of a tile
  const int n_tiles = a.teams * a.stages * 2 * g;
  for (int i = threadIdx.x; i < n_tiles * pad; i += blockDim.x) {
    const int t = i / pad, stage = t / (2 * g);
    unsigned char* kv =
        ring + static_cast<size_t>(stage) * a.stage_bytes + (g + t % (2 * g)) * tile;
    reinterpret_cast<uint4*>(kv + l * HD * 2)[i % pad] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < g * ns * nt_n * 128; i += blockDim.x) {
    const int e = i & 3, ln = (i >> 2) & 31, nt = (i >> 7) % nt_n, hs = (i >> 7) / nt_n;
    const int r = 16 * (hs % ns) + (ln >> 2) + 8 * (e >> 1);
    const int col = 8 * nt + 2 * (ln & 3) + (e & 1);
    const int head = hg * g + hs / ns;
    sbias[i] = col >= l ? -INFINITY
                        : r < l ? a.bias[(static_cast<long long>(head) * l + r) * l + col] * kLog2e
                                : 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.teams * a.stages; ++i) mbar_init(&full[i], 1);
  }
  fence_proxy_async();
  __syncthreads();

  // this team's items: windows w0 + (team + k * teams) * per, k < n_team
  const int n_items = static_cast<int>((a.windows - w0 + per - 1) / per);
  const int n_team = team < n_items ? (n_items - team + a.teams - 1) / a.teams : 0;
  const long long step = per * a.teams;
  unsigned char* tring = ring + static_cast<size_t>(team) * a.stages * a.stage_bytes;
  uint64_t* tfull = full + team * a.stages;
  const bool issuer = warp % team_warps == 0 && lane == 0;
  if (issuer) {
    for (int k = 0; k < n_team && k < a.stages; ++k) {
      load_item<HD>(a, &map, tring + k * a.stage_bytes, &tfull[k], hg,
                    static_cast<int>(w0 + team * per + k * step));
    }
  }

  const int gr = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * s + gr, r1 = r0 + 8;
  const int c = a.heads * HD;
  const int head = hg * g + h;
  const float4* bfr = reinterpret_cast<const float4*>(sbias) + (h * ns + s) * nt_n * 32 + lane;
  const float sl2 = a.scale * kLog2e;

  int slot = 0;
  uint32_t phase = 0;
  long long win = w0 + team * per;
  for (int k = 0; k < n_team; ++k, win += step) {
    unsigned char* st = tring + static_cast<size_t>(slot) * a.stage_bytes;
    mbar_wait(&tfull[slot], phase);
    unsigned char* sq = st + h * tile;
    const unsigned char* sk = sq + g * tile;
    const unsigned char* sv = sk + g * tile;

    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      ldsm_x4(qa[kk], sq + tile_off<HD>(16 * s + (lane & 15), 2 * kk + (lane >> 4)));
    }
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < nt_n) {
        uint32_t kb[HD / 8];
        const int kr = 8 * nt + (lane & 7);
        if constexpr (HD == 16) {
          ldsm_x2(kb, sk + tile_off<HD>(kr, (lane >> 3) & 1));
        } else {
#pragma unroll
          for (int half = 0; half < HD / 32; ++half) {
            ldsm_x4(kb + 4 * half, sk + tile_off<HD>(kr, 4 * half + (lane >> 3)));
          }
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          mma_bf16_16816(sc[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], kb[2 * kk],
                         kb[2 * kk + 1]);
        }
      }
    }

    // scores x log2 e: scale and bias in one fused multiply-add (the bias
    // is -inf on keys >= L), then the mask
    const float4* mfr = reinterpret_cast<const float4*>(st + tiles) + s * nt_n * 32 + lane;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < nt_n) {
        const float4 b4 = bfr[nt * 32];
        float v[4] = {fmaf(sc[nt][0], sl2, b4.x), fmaf(sc[nt][1], sl2, b4.y),
                      fmaf(sc[nt][2], sl2, b4.z), fmaf(sc[nt][3], sl2, b4.w)};
        if constexpr (MASKED) {
          const float4 m4 = mfr[nt * 32];
          v[0] = fmaf(m4.x, kLog2e, v[0]);
          v[1] = fmaf(m4.y, kLog2e, v[1]);
          v[2] = fmaf(m4.z, kLog2e, v[2]);
          v[3] = fmaf(m4.w, kLog2e, v[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = v[e];
        mx0 = fmaxf(mx0, fmaxf(v[0], v[1]));
        mx1 = fmaxf(mx1, fmaxf(v[2], v[3]));
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < nt_n) {
        sc[nt][0] = fast_exp2(sc[nt][0] - mx0);
        sc[nt][1] = fast_exp2(sc[nt][1] - mx0);
        sc[nt][2] = fast_exp2(sc[nt][2] - mx1);
        sc[nt][3] = fast_exp2(sc[nt][3] - mx1);
        sum0 += sc[nt][0] + sc[nt][1];
        sum1 += sc[nt][2] + sc[nt][3];
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
    const float inv0 = __frcp_rn(sum0), inv1 = __frcp_rn(sum1);
    // p in bf16 pairs, as p . v's A fragments (key tiles >= nt_n hold 0)
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      pa[ks][0] = pack_bf16(sc[2 * ks][0] * inv0, sc[2 * ks][1] * inv0);
      pa[ks][1] = pack_bf16(sc[2 * ks][2] * inv1, sc[2 * ks][3] * inv1);
      pa[ks][2] = pack_bf16(sc[2 * ks + 1][0] * inv0, sc[2 * ks + 1][1] * inv0);
      pa[ks][3] = pack_bf16(sc[2 * ks + 1][2] * inv1, sc[2 * ks + 1][3] * inv1);
    }
    float o[HD / 8][4];
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks < ks_n) {
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, sv + tile_off<HD>(16 * ks + (lane & 15), 2 * dp + (lane >> 4)));
          mma_bf16_16816(o[2 * dp], pa[ks][0], pa[ks][1], pa[ks][2], pa[ks][3], vb[0], vb[1]);
          mma_bf16_16816(o[2 * dp + 1], pa[ks][0], pa[ks][1], pa[ks][2], pa[ks][3], vb[2],
                         vb[3]);
        }
      }
    }

    // the output through this warp's q tile, then 16-byte stores of the
    // strip's valid rows
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      if (r0 < l) {
        *reinterpret_cast<uint32_t*>(sq + tile_off<HD>(r0, dn) + 4 * t4) =
            pack_bf16(o[dn][0], o[dn][1]);
      }
      if (r1 < l) {
        *reinterpret_cast<uint32_t*>(sq + tile_off<HD>(r1, dn) + 4 * t4) =
            pack_bf16(o[dn][2], o[dn][3]);
      }
    }
    __syncwarp();
    constexpr int kCpr = HD / 8;   // 16-byte chunks of a row of one head
    bf16* orow = a.out + win * l * c + head * HD;
#pragma unroll
    for (int j = lane; j < 16 * kCpr; j += 32) {
      const int rr = 16 * s + j / kCpr, ch = j % kCpr;
      if (rr < l) {
        *reinterpret_cast<uint4*>(orow + static_cast<long long>(rr) * c + ch * 8) =
            *reinterpret_cast<const uint4*>(sq + tile_off<HD>(rr, ch));
      }
    }
    // this thread's writes to the stage before TMA writes it again
    fence_proxy_async();
    bar_sync(1 + team, 32 * team_warps);
    if (issuer && k + a.stages < n_team) {
      load_item<HD>(a, &map, st, &tfull[slot], hg, static_cast<int>(win + a.stages * step));
    }
    if (++slot == a.stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
}

// A 2-D map of qkv [rows, c3] bf16 in boxes of [l rows, hd], swizzled by the
// box's row span (hd * 2 bytes: 32, 64 or 128).
__host__ inline int qkv_map(CUtensorMap* map, const void* qkv, long long rows, int c3, int hd,
                            int l) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c3), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c3) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(hd), static_cast<cuuint32_t>(l)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swz = hd == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                 : hd == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(qkv), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD, bool MASKED, int NT>
int launch_attn(const AttnArgs& a, const K7Plan& p, cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const int err = raise_smem_limit(window_attn_kernel<HD, MASKED, NT>,
                                   static_cast<size_t>(p.smem), &smem_configured);
  if (err) return err;
  CUtensorMap map;
  const int e = qkv_map(&map, a.qkv, a.windows * a.l, 3 * a.heads * HD, HD, a.l);
  if (e) return e;
  window_attn_kernel<HD, MASKED, NT><<<p.blocks, p.threads, p.smem, stream>>>(a, map);
  return static_cast<int>(cudaGetLastError());
}
// Windows of 7 x 7 tokens (every Swin configuration the repo has) take an
// instantiation with their 7 key tiles fixed at compile time: the unrolled
// loops over key tiles are then free of branches and the compiler schedules
// across them (K7 per swin_tiny forward at N = 120 by tools/kernel_ab.py:
// 0.77-0.83 against 0.96-1.07 ms with the count at run time, H100 80GB HBM3).
template <int HD>
int launch_attn_hd(const AttnArgs& a, const K7Plan& p, cudaStream_t stream) {
  if ((a.l + 7) / 8 == 7) {
    return a.mask != nullptr ? launch_attn<HD, true, 7>(a, p, stream)
                             : launch_attn<HD, false, 7>(a, p, stream);
  }
  return a.mask != nullptr ? launch_attn<HD, true, 0>(a, p, stream)
                           : launch_attn<HD, false, 0>(a, p, stream);
}

}  // namespace

extern "C" {

// K7's plan: out = {G, S, teams, stages, shared-memory bytes, threads,
// blocks}; returns 0 where K7 does not take the shape.
int gcv_k7_plan(int l, int heads, int hd, int masked, long long windows, int sms, int* out) {
  const K7Plan p = k7_plan(l, heads, hd, masked != 0, windows, sms);
  out[0] = p.group;
  out[1] = p.strips;
  out[2] = p.teams;
  out[3] = p.stages;
  out[4] = p.smem;
  out[5] = p.threads;
  out[6] = p.blocks;
  return p.group != 0;
}

// K7. qkv [windows, l, 3, heads, hd] bf16, bias [heads, l, l] f32, mask
// the windows' masks in fragment order [>= nw][ceil(l / 16)][ceil(l / 8)]
// [32][4] f32 (window_attn.py to_fragments) or null, out [windows, l, heads,
// hd] bf16; l <= 64 and hd in {16, 32, 64} (the caller checks); scale =
// hd^-1/2 as an f32.
int gcv_window_attention(const void* qkv, const void* bias, const void* mask, void* out,
                         long long windows, int l, int heads, int hd, int nw, float scale,
                         void* stream) {
  if (windows <= 0) return static_cast<int>(cudaGetLastError());
  const K7Plan p = k7_plan(l, heads, hd, mask != nullptr, windows, sm_count());
  if (p.group == 0) return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a;
  a.qkv = static_cast<const bf16*>(qkv);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.windows = windows;
  a.l = l;
  a.heads = heads;
  a.nw = nw;
  a.scale = scale;
  a.group = p.group;
  a.strips = p.strips;
  a.teams = p.teams;
  a.stages = p.stages;
  a.stage_bytes = k7_stage_bytes(p.group, p.strips, hd, l, mask != nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_attn_hd<16>(a, p, s);
    case 32: return launch_attn_hd<32>(a, p, s);
    case 64: return launch_attn_hd<64>(a, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
