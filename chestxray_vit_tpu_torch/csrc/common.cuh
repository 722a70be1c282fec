// Helpers shared by the kernels in this directory: strided [B, H, S, d]
// addressing, bf16 packing, the m16n8k16 tensor-core product, warp sums,
// the dropout hash and the segment ids of packed sequences.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

// Attention-probability dropout: the keep mask of the TPU kernels'
// `_keep_mask` / `_fmix32` (chestxray_vit_tpu/ops/flash_attention.py),
// hashed in registers from each score element's global index, so the
// forward and the backward regenerate the same mask and none is stored.
// Element (bh, row, col) hashes the counter (bh * q_pad + row) * s_pad + col
// (uint32, wrapping; q_pad and s_pad are the TPU wrapper's padded strides,
// logical constants here) XOR the mixed seed, and is kept when the murmur3
// finalizer of that reaches the threshold min(rate * 2^32, 2^32 - 1).
struct Dropout {
  uint32_t seed_mix;    // int32 seed read as uint32, times 0x9E3779B9
  uint32_t threshold;
  uint32_t q_pad, s_pad;
  float keep_prob;      // 1 - rate: the forward divides l by it
  float inv_keep;       // 1 / (1 - rate): the backward's scale
  unsigned char* keep;  // debug forward only: the mask out, [B * H, S, S]
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// The counter of (bh, row, col 0); add the column.
__device__ __forceinline__ uint32_t drop_row(const Dropout& d, int bh,
                                             int row) {
  return (static_cast<uint32_t>(bh) * d.q_pad + static_cast<uint32_t>(row)) *
         d.s_pad;
}

__device__ __forceinline__ bool kept(const Dropout& d, uint32_t row_base,
                                     int col) {
  return fmix32((row_base + static_cast<uint32_t>(col)) ^ d.seed_mix) >=
         d.threshold;
}

// Segment ids of packed sequences (the kSegment attention kernels): int32
// [B, S], read in 64-row tiles into shared memory. A tile none of whose
// ids lies in the block's id range is skipped. Compiled with
// -DCXR_NO_TILE_SKIP (tile_skip_probe.py, to measure what the test costs
// and saves) no tile is skipped and neither the range scan nor the
// per-tile vote runs: the ids ride on the barrier that follows the tile's
// own loads.
constexpr int kNoSegment = INT_MIN;  // the id of rows and keys at or past S

// The ids of the block's 64 rows starting at r0 into ``ids`` (kNoSegment at
// or past S) and their range into ``range``; all threads must call it.
__device__ __forceinline__ void load_block_ids(const int* __restrict__ seg,
                                               int r0, int S, int* ids,
                                               int* range) {
  const int tid = threadIdx.x;
  if (tid < 64) ids[tid] = r0 + tid < S ? seg[r0 + tid] : kNoSegment;
  __syncthreads();
#ifndef CXR_NO_TILE_SKIP
  if (tid == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = 0; i < 64 && r0 + i < S; ++i) {
      lo = min(lo, ids[i]);
      hi = max(hi, ids[i]);
    }
    range[0] = lo;
    range[1] = hi;
  }
  __syncthreads();
#endif
}

// Loads the ids of the 64-row tile at r0 into ``ids`` and tells the whole
// block whether any of them lies in [lo, hi]; holds a barrier, so all
// threads must call it, after the previous tile's ids are consumed.
__device__ __forceinline__ bool load_tile_ids(const int* __restrict__ seg,
                                              int r0, int S, int lo, int hi,
                                              int* ids) {
  const int tid = threadIdx.x;
  bool hit = false;
  if (tid < 64) {
    const int id = r0 + tid < S ? seg[r0 + tid] : kNoSegment;
    hit = r0 + tid < S && id >= lo && id <= hi;
    ids[tid] = id;
  }
#ifdef CXR_NO_TILE_SKIP
  return true;
#else
  return __syncthreads_or(hit);
#endif
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
