// Device helpers shared by the port's kernel sources (each source is its own
// translation unit; everything here has internal linkage).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// GELU (erf form) with the rational erf of genconvit_tpu/ops/act.py:34-45,
// Horner in z^2, pinned to sign(z) beyond the fit range.
__device__ __forceinline__ float gelu_rational(float h, int hp) {
  const float z = h * 0.7071067811865476f;
  const float zmax = hp ? 3.625f : 3.0f;
  const float zc = fminf(fmaxf(z, -zmax), zmax);
  const float t = zc * zc;
  float p, q;
  if (hp) {
    p = -1.0666330908322879e-06f;
    p = p * t + 0.00015586043306483894f;
    p = p * t + 0.0057354856364086396f;
    p = p * t + 0.057255831726436376f;
    p = p * t + 0.2571863689937213f;
    p = p * t + 1.1283791233432234f;
    q = 0.0013449923247288303f;
    q = q * t + 0.018689943146010534f;
    q = q * t + 0.13783698081066592f;
    q = q * t + 0.5612572789010719f;
    q = q * t + 1.0f;
  } else {
    p = -0.00044320715362244646f;
    p = p * t + 0.023272086736849436f;
    p = p * t + 0.2362246069042269f;
    p = p * t + 1.1279169492647987f;
    q = 0.10605450434127411f;
    q = q * t + 0.5398383027204903f;
    q = q * t + 1.0f;
  }
  float r = __fdividef(1.0f, q);  // q in [1, 3): fast reciprocal
  r = r * (2.0f - q * r);          // + one Newton step
  float e = zc * p * r;
  if (fabsf(z) >= zmax) e = copysignf(1.0f, z);
  return 0.5f * h * (1.0f + e);
}

// Raise a kernel's dynamic shared-memory limit to `bytes` once per
// instantiation (kernel is that instantiation's function; `configured` its
// own static).
template <class Kernel>
__host__ int raise_smem_limit(Kernel kernel, size_t bytes, size_t* configured) {
  if (bytes > *configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    *configured = bytes;
  }
  return 0;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// Wait until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A . B on the tensor cores, one warp: m16n8k16, bf16 in, f32 sum.
// Fragments (lane = 4 * g + t): a0 (row g, k 2t..2t+1), a1 (row g+8, same
// k), a2 (row g, k 2t+8..2t+9), a3 (row g+8, same k); b0 (k 2t..2t+1,
// column g), b1 (k 2t+8..2t+9, column g); d0, d1 (row g, columns 2t, 2t+1),
// d2, d3 (row g+8, same columns). The lower k sits in the lower half.
__device__ __forceinline__ void mma_bf16_16816(float* d, uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D += A . B, int8 in, int32 sum: m16n8k32. Fragments: a0 (row g, k
// 4t..4t+3), a1 (row g+8, same k), a2 (row g, k 16+4t..16+4t+3), a3 (row
// g+8, same k); b0 (k 4t..4t+3, column g), b1 (k 16+4t..16+4t+3, column g);
// d as m16n8k16. The lowest k sits in the lowest byte.
__device__ __forceinline__ void mma_s8_16832(int* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16x2 product and sum, each rounded once to bf16 (sm_90 mul.rn / add.rn:
// an explicit rounding modifier is never fused into a multiply-add).
__device__ __forceinline__ uint32_t bf162_bits(bf162 v) { return *reinterpret_cast<uint32_t*>(&v); }

__device__ __forceinline__ bf162 bf162_from_bits(uint32_t u) { return *reinterpret_cast<bf162*>(&u); }

__device__ __forceinline__ bf162 bf16x2_mul_rn(bf162 a, bf162 b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(bf162_bits(a)), "r"(bf162_bits(b)));
  return bf162_from_bits(d);
}

__device__ __forceinline__ bf162 bf16x2_add_rn(bf162 a, bf162 b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(bf162_bits(a)), "r"(bf162_bits(b)));
  return bf162_from_bits(d);
}

}  // namespace
