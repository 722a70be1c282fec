// Helpers shared by the kernels in this directory: strided [B, H, S, d]
// addressing, bf16 packing, the m16n8k16 tensor-core product and warp sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cxr {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, s;  // in elements; the head dim is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// D += A * B on the tensor cores, bf16 in, f32 accumulate. Fragment layout
// (g = lane / 4, t = lane % 4): A rows g and g + 8, columns 2t, 2t + 1
// (a0, a1) and 2t + 8, 2t + 9 (a2, a3); B column g, rows 2t, 2t + 1 (b0)
// and 2t + 8, 2t + 9 (b1); D rows g (d0, d1) and g + 8 (d2, d3) at
// columns 2t, 2t + 1.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment of an [n][k] tile in shared memory (k contiguous), for
// columns n0 + g and the 16-deep slice starting at k0.
template <int kLd>
__device__ __forceinline__ void load_b(const __nv_bfloat16 (*tile)[kLd], int n0,
                                       int k0, int g, int t, uint32_t& b0,
                                       uint32_t& b1) {
  b0 = *reinterpret_cast<const uint32_t*>(&tile[n0 + g][k0 + 2 * t]);
  b1 = *reinterpret_cast<const uint32_t*>(&tile[n0 + g][k0 + 2 * t + 8]);
}

// The A fragments of 16 rows [r0, r0 + 16) x 64 columns of a shared tile.
template <int kLd>
__device__ __forceinline__ void load_a(const __nv_bfloat16 (*tile)[kLd], int r0,
                                       int g, int t, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(&tile[r0 + g][c]);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(&tile[r0 + g + 8][c]);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(&tile[r0 + g][c + 8]);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(&tile[r0 + g + 8][c + 8]);
  }
}

// Accumulator tiles [16 x 64] (8 tiles of 8 columns) → A fragments of the
// same 16 x 64 block rounded to bf16: the product's output feeds the next
// product without a trip through shared memory.
__device__ __forceinline__ void acc_to_a(const float (&c)[8][4],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int kk = n >> 1, hi = (n & 1) * 2;
    a[kk][hi] = pack_bf16x2(c[n][0], c[n][1]);
    a[kk][hi + 1] = pack_bf16x2(c[n][2], c[n][3]);
  }
}

}  // namespace cxr
