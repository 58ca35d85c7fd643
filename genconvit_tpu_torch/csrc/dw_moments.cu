// Hand-written Hopper (sm_90a) probe kernel: a depthwise 7x7 convolution
// with its per-pixel moments, with a plain C interface loaded through ctypes
// (genconvit_tpu_torch/ops/cuda/dw_moments.py). No PyTorch headers.
//
// M3  gcv_dw_moments  replaces the Pallas kernel `kernel` of
//     tools/microbench_dwshift.py (entry shift7_fn; pallas_call at :108).
//     Per pixel of an NHWC bf16 activation x [N, H, W, C], with f32 weights
//     k [7, 7, C] and bias b [C] (:93-103):
//
//       acc  = b + sum over (dy, dx) of x[y+dy-3, x+dx-3] * k[dy, dx]   f32, zero halo
//       dw   = bf16(acc)
//       mean = sum_c(acc) / C,  var = sum_c(acc^2) / C - mean^2          of the f32 acc
//
//     The moments come from the f32 sum before its bf16 rounding, as the
//     Pallas kernel takes them (not from the rounded dw, as the tool's
//     xla_fn and the port's Block.forward_folded do). This is the first
//     half of the LN-folded block (models/convnext.py, forward_folded:
//     self.dw(x), then _row_moments), the part a kernel for that block
//     would fuse. Each tap is one fused multiply-add: a bf16 x f32 product
//     is not exact in f32, so against a multiply then an add it may differ
//     by an f32 ulp per tap; with bf16-representable weights (the tests
//     and chip_smoke.py) the product is exact and the two agree bit for bit.
//     What bounds it on the card: the taps, 2 * 49 * N*H*W*C f32 operations
//     at 67 TFLOP/s, a little above the bytes (x in and dw out once, 4
//     bytes a channel, plus 8 bytes of moments a pixel).
//     What the design does: the TPU kernel pre-shifts 7 copies of a padded
//     slab in VMEM so that every tap is an aligned vector read; here a
//     warp owns 8 consecutive pixels of one image row and walks the
//     channel pairs, one pair per lane at a time: per image row dy it
//     loads the 7 weights and the 14 pixels of the window once and feeds
//     them to 56 fused multiply-adds, so a tap costs about one instruction
//     and the 49-fold reuse of x is served from registers and L1 (the
//     sliding window of K5's taps, block_wgmma.cuh). The per-pixel sums of acc and acc^2
//     collect in registers across the pairs and meet in one warp reduction
//     per pixel; lane 0 writes mean and var. No shared memory, no padded
//     copy of x.
//
// The entry point returns cudaGetLastError() after its launch.

#include "common.cuh"

namespace {

constexpr int kDwThreads = 256;
constexpr int kDwWarps = kDwThreads / 32;
constexpr int kRun = 8;   // pixels of one image row per warp

__global__ void __launch_bounds__(kDwThreads)
dw_moments_kernel(const bf16* x, const float* k, const float* b, bf16* dw, float* mu,
                  float* var, int n, int h, int w, int c) {
  const int runs = (w + kRun - 1) / kRun;
  const long long task = static_cast<long long>(blockIdx.x) * kDwWarps + threadIdx.x / 32;
  if (task >= static_cast<long long>(n) * h * runs) return;
  const int lane = threadIdx.x % 32;
  const int x0 = static_cast<int>(task % runs) * kRun;
  const long long ny = task / runs;          // n * h + y
  const int py = static_cast<int>(ny % h);
  const long long img = ny - py;             // n * h
  const int half_c = c / 2;
  const float2* k2 = reinterpret_cast<const float2*>(k);
  const float2* b2 = reinterpret_cast<const float2*>(b);
  float s[kRun], q[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) s[i] = q[i] = 0.f;

  for (int j = lane; j < half_c; j += 32) {
    float2 acc[kRun];
    const float2 bj = b2[j];
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = bj;
    for (int dy = 0; dy < 7; ++dy) {
      const int yy = py + dy - 3;
      if (yy < 0 || yy >= h) continue;
      const bf162* xr = reinterpret_cast<const bf162*>(x + (img + yy) * static_cast<long long>(w) * c);
      float2 wt[7];
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) wt[dx] = k2[(dy * 7 + dx) * half_c + j];
      float2 win[kRun + 6];
#pragma unroll
      for (int r = 0; r < kRun + 6; ++r) {
        const int xx = x0 - 3 + r;
        win[r] = xx >= 0 && xx < w ? __bfloat1622float2(xr[xx * half_c + j]) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          acc[i].x = fmaf(win[i + dx].x, wt[dx].x, acc[i].x);
          acc[i].y = fmaf(win[i + dx].y, wt[dx].y, acc[i].y);
        }
      }
    }
    bf162* dr = reinterpret_cast<bf162*>(dw + (ny * w + x0) * static_cast<long long>(c));
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (x0 + i < w) dr[i * half_c + j] = __floats2bfloat162_rn(acc[i].x, acc[i].y);
      s[i] += acc[i].x + acc[i].y;
      q[i] += acc[i].x * acc[i].x + acc[i].y * acc[i].y;
    }
  }
  const float inv_c = 1.0f / static_cast<float>(c);
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const float sum = warp_sum(s[i]);
    const float sumsq = warp_sum(q[i]);
    if (lane == 0 && x0 + i < w) {
      const float mean = __fmul_rn(sum, inv_c);
      mu[ny * w + x0 + i] = mean;
      var[ny * w + x0 + i] = __fsub_rn(__fmul_rn(sumsq, inv_c), __fmul_rn(mean, mean));
    }
  }
}

}  // namespace

extern "C" {

// M3. x, dw [n, h, w, c] bf16 NHWC; k [7, 7, c] and b [c] f32; mu, var
// [n, h, w] f32; c even (the caller checks).
int gcv_dw_moments(const void* x, const void* k, const void* b, void* dw, void* mu, void* var,
                   int n, int h, int w, int c, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  const long long tasks = static_cast<long long>(n) * h * ((w + kRun - 1) / kRun);
  const long long blocks = (tasks + kDwWarps - 1) / kDwWarps;
  dw_moments_kernel<<<static_cast<unsigned int>(blocks), kDwThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(k), static_cast<const float*>(b),
      static_cast<bf16*>(dw), static_cast<float*>(mu), static_cast<float*>(var), n, h, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
