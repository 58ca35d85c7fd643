// Hand-written Hopper (sm_90a) kernel for Swin's windowed multi-head
// attention, with a plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/window_attn.py). No PyTorch headers.
//
// K7  gcv_window_attention  replaces the Pallas kernels _attn_kernel and
//     _attn_kernel_nomask of genconvit_tpu/ops/pallas/window_attn.py (entry
//     window_attention_pallas): per window-head g,
//       out = bf16(bf16(softmax(q . k^T * hd^-1/2 + bias[head] (+ mask[win]))) . v)
//     with f32 scores, the accurate expf, a true division by the row sum and
//     an f32 sum of the second product; head = g % heads, win = (g / heads)
//     % nw. It reads the qkv linear's output [B, L, 3, heads, hd] directly
//     and writes [B, L, heads, hd], the proj linear's input, so the two
//     permute copies around the JAX package's kernel are not made.
//     What bounds it on the card: the bytes. Every window-head reads q, k,
//     v (3 * L * hd * 2 bytes) and writes its output once; its two products
//     (4 * L^2 * hd operations) are far below the tensor cores' rate for
//     those bytes (about 19 operations a byte at L = 49, hd = 32, against
//     the card's ~295), and the softmax's ~8 f32 operations a score are
//     below the f32 cores' rate too.
//     What the design does: one warp per window-head, four per thread
//     block, nothing shared between warps (no block barrier; a ragged last
//     block just has idle warps). A warp stages q and k (cp.async) and v
//     (transposed, v^T[d][t]) in its own shared memory with L padded to 64
//     and zero-filled. Per 16-row strip of queries it computes the scores
//     with mma.sync m16n8k16 (bf16 in, f32 sum) into registers, scales them
//     and adds the bias and the mask, sets the padded key columns to -inf,
//     takes the row max and sum across the four lanes that share a row
//     (shuffles), writes p rounded to bf16 to a 16 x 64 strip in shared
//     memory, and runs p . v with mma.sync from there; padded query rows are
//     never stored. The first version: the scores are scaled after the
//     product (q . k * hd^-1/2, not (q * hd^-1/2) . k; f32 noise), the
//     output leaves as 4-byte stores, and the loads wait in order.
//
// The entry point returns cudaGetLastError() after its launch.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kLMax = 64;               // tokens per window, padded
constexpr int kAttnWarps = 4;           // window-heads per thread block
constexpr int kRowPad = 8;              // bf16 padding of a shared row (bank spread)
constexpr int kPStride = kLMax + kRowPad;  // row of v^T and of the p strip

// One warp's shared memory, in bf16 elements: q and k [64][HD + 8], v^T
// [HD][72], the p strip [16][72]. Every part starts 16-byte aligned.
template <int HD>
struct WarpSmem {
  static constexpr int kQStride = HD + kRowPad;
  static constexpr int kQ = kLMax * kQStride;
  static constexpr int kVt = HD * kPStride;
  static constexpr int kP = 16 * kPStride;
  static constexpr int kElems = 2 * kQ + kVt + kP;
  static constexpr size_t kBytes = static_cast<size_t>(kElems) * 2;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
__global__ void __launch_bounds__(kAttnWarps * 32)
window_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                   const float* __restrict__ mask, bf16* __restrict__ out, long long g_total,
                   int l, int heads, int nw, float scale) {
  using S = WarpSmem<HD>;
  constexpr int QS = S::kQStride;
  constexpr int kChunks = HD / 8;   // 16-byte chunks of a token's q, k or v
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gi = static_cast<long long>(blockIdx.x) * kAttnWarps + warp;
  if (gi >= g_total) return;
  bf16* sq = reinterpret_cast<bf16*>(smem) + warp * S::kElems;
  bf16* sk = sq + S::kQ;
  bf16* svt = sk + S::kQ;
  bf16* sp = svt + S::kVt;

  const long long win = gi / heads;   // the window (row of B)
  const int head = static_cast<int>(gi - win * heads);
  const int c = heads * HD;
  const long long tok = 3LL * c;      // elements from one token's qkv to the next
  const bf16* q0 = qkv + win * l * tok + head * HD;

  // q and k by 16-byte async copies, rows >= l zero-filled
  for (int i = lane; i < kLMax * kChunks; i += 32) {
    const int t = i / kChunks, ch = i % kChunks;
    const bool in = t < l;
    const bf16* src = q0 + (in ? t : 0) * tok + ch * 8;
    cp_async16_zfill(sq + t * QS + ch * 8, src, in ? 16 : 0);
    cp_async16_zfill(sk + t * QS + ch * 8, src + c, in ? 16 : 0);
  }
  cp_async_commit();
  // v transposed, v^T[d][t], columns t >= l zero
  for (int i = lane; i < kLMax * kChunks; i += 32) {
    const int t = i % kLMax, ch = i / kLMax;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (t < l) raw = *reinterpret_cast<const uint4*>(q0 + t * tok + 2 * c + ch * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) svt[(ch * 8 + j) * kPStride + t] = e[j];
  }
  cp_async_wait<0>();
  __syncwarp();

  const float* bh = bias + static_cast<long long>(head) * l * l;
  const float* mw = mask == nullptr ? nullptr : mask + (win % nw) * l * l;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment coordinates
  const int strips = (l + 15) >> 4;
  bf16* const orow = out + win * l * c + head * HD;

  for (int ms = 0; ms < strips; ++ms) {
    const int r0 = ms * 16 + g, r1 = r0 + 8;
    // scores of the strip: s[nt] holds rows r0, r1 x key columns nt*8 + 2*t4, +1
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int k0 = kk * 16 + 2 * t4;
      const uint32_t a0 = ld32(sq + r0 * QS + k0), a1 = ld32(sq + r1 * QS + k0);
      const uint32_t a2 = ld32(sq + r0 * QS + k0 + 8), a3 = ld32(sq + r1 * QS + k0 + 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 < l) {
          const bf16* kr = sk + (nt * 8 + g) * QS + k0;
          mma_bf16_16816(s[nt], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
        }
      }
    }
    // scale, bias, mask; keys >= l are -inf; row max over the quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1;
        const int col = nt * 8 + 2 * t4 + (e & 1);
        float v = -INFINITY;
        if (col < l) {
          v = __fmul_rn(s[nt][e], scale);
          if (r < l) {
            v = __fadd_rn(v, bh[r * l + col]);
            if (mw != nullptr) v = __fadd_rn(v, mw[r * l + col]);
          }
        }
        s[nt][e] = v;
        if (e < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // exp (accurate expf) and the row sums; padded rows and keys give 0
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1;
        const int col = nt * 8 + 2 * t4 + (e & 1);
        const float x = (r < l && col < l) ? expf(__fsub_rn(s[nt][e], e < 2 ? mx0 : mx1)) : 0.0f;
        s[nt][e] = x;
        if (e < 2) sum0 = __fadd_rn(sum0, x); else sum1 = __fadd_rn(sum1, x);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, o));
      sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, o));
    }
    // p = e / sum, rounded to bf16, into the strip (rows >= l: 0)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      const float p0 = r0 < l ? __fdiv_rn(s[nt][0], sum0) : 0.0f;
      const float p1 = r0 < l ? __fdiv_rn(s[nt][1], sum0) : 0.0f;
      const float p2 = r1 < l ? __fdiv_rn(s[nt][2], sum1) : 0.0f;
      const float p3 = r1 < l ? __fdiv_rn(s[nt][3], sum1) : 0.0f;
      *reinterpret_cast<bf162*>(sp + g * kPStride + col) = __floats2bfloat162_rn(p0, p1);
      *reinterpret_cast<bf162*>(sp + (g + 8) * kPStride + col) = __floats2bfloat162_rn(p2, p3);
    }
    __syncwarp();
    // o = p . v over the key steps that hold tokens < l (p is 0 past l)
    float o[HD / 8][4];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kLMax / 16; ++ks) {
      if (ks < strips) {
        const int k0 = ks * 16 + 2 * t4;
        const uint32_t a0 = ld32(sp + g * kPStride + k0);
        const uint32_t a1 = ld32(sp + (g + 8) * kPStride + k0);
        const uint32_t a2 = ld32(sp + g * kPStride + k0 + 8);
        const uint32_t a3 = ld32(sp + (g + 8) * kPStride + k0 + 8);
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          const bf16* vr = svt + (nt * 8 + g) * kPStride + k0;
          mma_bf16_16816(o[nt], a0, a1, a2, a3, ld32(vr), ld32(vr + 8));
        }
      }
    }
    if (r0 < l) {
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        *reinterpret_cast<bf162*>(orow + static_cast<long long>(r0) * c + nt * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[nt][0], o[nt][1]);
    }
    if (r1 < l) {
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        *reinterpret_cast<bf162*>(orow + static_cast<long long>(r1) * c + nt * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[nt][2], o[nt][3]);
    }
    __syncwarp();   // the next strip rewrites p
  }
}

template <int HD>
int launch_attn(const bf16* qkv, const float* bias, const float* mask, bf16* out,
                long long windows, int l, int heads, int nw, float scale,
                cudaStream_t stream) {
  static size_t smem_configured = 0;  // per instantiation, on the current device
  const size_t smem = kAttnWarps * WarpSmem<HD>::kBytes;
  const int err = raise_smem_limit(window_attn_kernel<HD>, smem, &smem_configured);
  if (err) return err;
  const long long g_total = windows * heads;
  const long long blocks = (g_total + kAttnWarps - 1) / kAttnWarps;
  window_attn_kernel<HD><<<static_cast<unsigned int>(blocks), kAttnWarps * 32, smem, stream>>>(
      qkv, bias, mask, out, g_total, l, heads, nw, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K7. qkv [windows, l, 3, heads, hd] bf16, bias [heads, l, l] f32, mask
// [>= nw, l, l] f32 or null, out [windows, l, heads, hd] bf16; l <= 64 and
// hd in {16, 32, 64} (the caller checks); scale = hd^-1/2 as an f32.
int gcv_window_attention(const void* qkv, const void* bias, const void* mask, void* out,
                         long long windows, int l, int heads, int hd, int nw, float scale,
                         void* stream) {
  if (windows <= 0) return static_cast<int>(cudaGetLastError());
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_attn<16>(q, b, m, o, windows, l, heads, nw, scale, s);
    case 32: return launch_attn<32>(q, b, m, o, windows, l, heads, nw, scale, s);
    case 64: return launch_attn<64>(q, b, m, o, windows, l, heads, nw, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
