// Helpers shared by the kernels in this directory: strided [B, H, S, d]
// addressing, bf16 packing, warp sums, the dropout hash, the segment ids of
// packed sequences, and the Hopper tile machinery of the bf16 attention
// kernels (cp.async into 128-byte swizzled tiles, ldmatrix, wgmma with B
// read through a descriptor) and of the int8 kernel (the same tiles of int8,
// the s8 wgmma).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cxr {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The head dims the attention kernels take (a multiple of 8 from 8 to
// 128), and the padded width, 64 or 128, each is built at. d = 64 has an
// instantiation of its own with no column masks (kPad false), the code the
// kernels ran before other head dims; every other d masks the columns at or
// past it (d = 128 too, which saves a fourth instantiation).
__host__ __device__ constexpr bool head_dim_ok(int d) {
  return d % 8 == 0 && d >= 8 && d <= 128;
}
__host__ __device__ constexpr int padded_head_dim(int d) {
  return d <= 64 ? 64 : 128;
}

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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two bf16 halves of a packed word as floats (exact).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// 2^x on the special-function unit alone (ex2.approx.ftz: about 2 ulp;
// results below 2^-126 are flushed to 0, which is all exp2f adds the
// instructions for).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
// Element (bh, row, col) of the call hashes the counter
// (g * q_pad + row) * s_pad + col (uint32, wrapping; q_pad and s_pad are the
// TPU wrapper's padded strides, logical constants here) XOR the mixed seed,
// and is kept when the murmur3 finalizer of that reaches the threshold
// min(rate * 2^32, 2^32 - 1). g is the global (batch * head) index of the
// call's (batch row b, head h): the call holds some of the model's
// `heads_total` heads, from head `head_base` on, and its batch row b is
// global row bh_base / heads_total + b, so g = bh_base + b * heads_total +
// head_base + h. A data-parallel rank's rows and a tensor-parallel rank's
// heads thus draw their slice of the global batch's mask; a whole-head call
// (heads_total the call's heads, head_base 0) has g = bh_base + bh.
struct Dropout {
  uint32_t seed_mix;    // int32 seed read as uint32, times 0x9E3779B9
  uint32_t threshold;
  uint32_t q_pad, s_pad;
  uint32_t bh_base;     // global index of batch row 0, head 0 (row * heads_total)
  uint32_t heads_total; // heads of the model
  uint32_t head_base;   // the call's first head in the model
  float keep_prob;      // 1 - rate: the forward divides l by it
  float inv_keep;       // 1 / (1 - rate): the backward's scale
  unsigned char* keep;  // debug forward only: the mask out, [B * H, S, S]
};

// The entry points' check of the head fields: the call's heads lie within
// the model's.
inline bool dropout_heads_ok(int heads, int heads_total, int head_base) {
  return heads > 0 && head_base >= 0 && heads_total >= head_base + heads;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// The counter of (batch row b, head h of the call, query 0, key 0), from
// the b and h a kernel has already; a query row adds row * s_pad
// (drop_row), a key its index.
__device__ __forceinline__ uint32_t drop_base(const Dropout& d, int b,
                                              int h) {
  return (d.bh_base + static_cast<uint32_t>(b) * d.heads_total +
          d.head_base + static_cast<uint32_t>(h)) *
         d.q_pad * d.s_pad;
}

// The counter of (query row, key 0) from drop_base's; add the key.
__device__ __forceinline__ uint32_t drop_row(const Dropout& d, uint32_t base,
                                             int row) {
  return base + static_cast<uint32_t>(row) * d.s_pad;
}

__device__ __forceinline__ bool kept(const Dropout& d, uint32_t row_base,
                                     int col) {
  return fmix32((row_base + static_cast<uint32_t>(col)) ^ d.seed_mix) >=
         d.threshold;
}

// Segment ids of packed sequences (the kSegment attention kernels): int32
// [B, S]. A 64-row tile none of whose ids lies in the range of the block's
// own ids is skipped: the f32 kernels read the ids tile by tile into shared
// memory and vote (load_block_ids, load_tile_ids), the bf16 ones find the
// tiles to visit before their copies are issued (TileWalk). Compiled with
// -DCXR_NO_TILE_SKIP (tile_skip_probe.py, to measure what the test costs
// and saves) no tile is skipped and neither the range scan nor the
// per-tile vote runs.
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

// The 64-row tiles of the walked operand (keys for the forward and the dQ
// pass, queries for the dK/dV pass) that a block of 64 own rows visits, in
// order. Dense: all of them. kSegment: those with an id inside the range of
// the block's own ids (conservative, ids in any order), found 32 tiles at a
// time from the ids in device memory. Every warp computes the same answer
// from the same ids, so the walk is block-uniform without a barrier or
// shared memory.
template <bool kSegment>
struct TileWalk {
#ifdef CXR_NO_TILE_SKIP
  static constexpr bool kSkip = false;
#else
  static constexpr bool kSkip = kSegment;
#endif
  static constexpr int kTile = 64;
  const int* seg;
  int S, tiles, lo, hi, base;
  uint32_t mask;

  // ``seg``: the ids of this batch row; r0: the block's first own row.
  __device__ __forceinline__ TileWalk(const int* seg_, int S_, int r0)
      : seg(seg_), S(S_), tiles((S_ + kTile - 1) / kTile), lo(0), hi(0),
        base(kSkip ? -32 : 0), mask(0u) {
    if (kSkip) {
      const int lane = threadIdx.x & 31;
      lo = INT_MAX;
      hi = INT_MIN;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r0 + lane + 32 * j;
        if (r < S) {
          const int id = seg[r];
          lo = min(lo, id);
          hi = max(hi, id);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
    }
  }

  // Bit j: tile base + j holds an id in [lo, hi].
  __device__ __forceinline__ uint32_t scan() const {
    const int lane = threadIdx.x & 31;
    uint32_t m = 0u;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      bool hit = false;
      if (base + j < tiles) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = (base + j) * kTile + lane + 32 * half;
          if (r < S) {
            const int id = seg[r];
            hit = hit || (id >= lo && id <= hi);
          }
        }
      }
      if (__any_sync(0xffffffffu, hit)) m |= 1u << j;
    }
    return m;
  }

  // The next tile to visit, or -1 when the walk is over.
  __device__ __forceinline__ int next() {
    if (kSkip) {
      while (mask == 0u) {
        base += 32;
        if (base >= tiles) return -1;
        mask = scan();
      }
      const int j = __ffs(mask) - 1;
      mask &= mask - 1u;
      return base + j;
    }
    return base < tiles ? base++ : -1;
  }
};

// Accumulator tiles [16 x 64] (8 tiles of 8 columns: c[n] holds rows g and
// g + 8 at columns 8n + 2t, 8n + 2t + 1, with g = lane / 4, t = lane % 4) →
// the A fragments of the same 16 x 64 block rounded to bf16 (a[kk]: rows g,
// g + 8 at columns 16kk + 2t, + 1 in a[kk][0], a[kk][1] and 8 further in
// a[kk][2], a[kk][3]): the product's output feeds the next product without
// a trip through shared memory.
__device__ __forceinline__ void acc_to_a(const float (&c)[8][4],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int kk = n >> 1, hi = (n & 1) * 2;
    a[kk][hi] = pack_bf16x2(c[n][0], c[n][1]);
    a[kk][hi + 1] = pack_bf16x2(c[n][2], c[n][3]);
  }
}

// ---------------------------------------------------------------------------
// 64 x 64 bf16 tiles in shared memory under the 128-byte swizzle, filled by
// cp.async and multiplied by wgmma. A tile is 64 rows of 128 bytes at a
// 1024-byte aligned shared address; the 16-byte chunk c of row r lies at
// chunk c ^ (r & 7), which is the layout a wgmma descriptor with the
// 128-byte swizzle reads and which ldmatrix reads without bank conflicts.
// Shared addresses are the 32-bit ones of the shared window.
// ---------------------------------------------------------------------------

constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// 16 or 4 bytes from global to shared memory without passing registers;
// with ``valid`` false nothing is read and zeros are written.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most kPending of this thread's committed groups are in
// flight, and makes what arrived visible to wgmma's reads (the async proxy).
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Starts the copies of the 64 x 64 tile whose first row is r0 of the strided
// [S, 64] operand ``src`` (rows at or past S as zeros) into the swizzled
// tile at ``dst``: four 16-byte copies per thread of a 128-thread block.
__device__ __forceinline__ void copy_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int r0,
                                                int S) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = threadIdx.x + 128 * j, r = i >> 3, c = i & 7;
    const bool valid = r0 + r < S;
    cp_async_16(dst + swizzled(r, c),
                src + (valid ? r0 + r : 0) * stride + c * 8, valid);
  }
}

// The same for the 64-column chunk ``chunk`` of a strided [S, d] operand
// whose head dim d is padded (d % 64 != 0): columns at or past d arrive as
// zeros and are not read (d is a multiple of 8, so a 16-byte piece is all
// in or all out). A head dim above 64 is a row of such chunks, each its own
// tile.
__device__ __forceinline__ void copy_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int r0,
                                                int S, int chunk, int d) {
  const int c = threadIdx.x & 7, col = chunk * 64 + c * 8;
  const bool col_ok = col < d;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (threadIdx.x + 128 * j) >> 3;
    const bool valid = col_ok && r0 + r < S;
    cp_async_16(dst + swizzled(r, c),
                src + (valid ? (r0 + r) * stride + col : 0), valid);
  }
}

// The copy of chunk ``chunk`` of a d-wide operand: masked by column when the
// head dim is padded (kPad), else the plain copy of the one chunk of d = 64.
template <bool kPad>
__device__ __forceinline__ void copy_chunk_async(uint32_t dst,
                                                 const __nv_bfloat16* src,
                                                 long long stride, int r0,
                                                 int S, int chunk, int d) {
  if constexpr (kPad)
    copy_tile_async(dst, src, stride, r0, S, chunk, d);
  else
    copy_tile_async(dst, src, stride, r0, S);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// wgmma's per-warp A fragments (acc_to_a's layout) of rows [r0, r0 + 16) x
// 64 columns of a swizzled tile.
__device__ __forceinline__ void load_a_swizzled(uint32_t tile, int r0,
                                                int lane, uint32_t (&a)[4][4]) {
  const int i = lane >> 3, row = r0 + (lane & 7) + (i & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(tile + swizzled(row, kk * 2 + (i >> 1)), a[kk][0], a[kk][1],
                a[kk][2], a[kk][3]);
}

// wgmma's shared-memory descriptor of a swizzled tile: start address,
// leading and stride byte offsets in 16-byte units, and the 128-byte swizzle
// mode in bits 62-63. K-major (rows are m or n, the 128 bytes run along k;
// the form of an A operand and of a plain B): groups of 8 rows are 1024
// bytes apart (stride offset), the leading offset is not used, and k-step
// kk starts 32 kk bytes further. MN-major (rows are k, the 128 bytes are
// the 64 values of n; the transposed-B form): groups of 8 k-rows are 1024
// bytes apart (stride offset), the leading offset would step to a second
// 64-wide n block, and k-step kk starts 2048 kk bytes further.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Orders the register and shared-memory accesses of the wgmma that follow
// after everything before; the operands named here were written by ordinary
// instructions, which the compiler must not move below the fence.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  wgmma_fence();
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// The compiler keeps every ordinary read and write of ``acc`` on its side
// of this point: after a wait, before the fence of an accumulator that
// ordinary instructions have set.
__device__ __forceinline__ void acc_fence(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[n][e])::"memory");
}
template <int kN>
__device__ __forceinline__ void acc_fence(float (&acc)[kN][8][4]) {
#pragma unroll
  for (int c = 0; c < kN; ++c) acc_fence(acc[c]);
}
// Waits until at most kPending committed groups are in flight; ``acc`` is
// an accumulator of a group that has then finished (or kN of them: the
// 64-column chunks of a head dim above 64).
template <int kPending>
__device__ __forceinline__ void wgmma_wait(float (&acc)[8][4]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
  acc_fence(acc);
}
template <int kPending, int kN>
__device__ __forceinline__ void wgmma_wait(float (&acc)[kN][8][4]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
  acc_fence(acc);
}

// The 32 accumulator registers of a thread as asm operands %0 ... %31.
#define CXR_WGMMA_ACC(d)                                              \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),         \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),     \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),     \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),     \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),     \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),     \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),     \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define CXR_WGMMA_M64N64K16                                            \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}, "

// One asynchronous m64n64k16 step of a warpgroup: D (+)= A B with this
// warp's 16 x 16 A fragment a[kk] in registers (acc_to_a's layout), B a
// 16-deep slice of a swizzled tile through its descriptor (kTransB:
// MN-major), D the warp's 16 x 64 accumulator in acc_to_a's input layout,
// d[n] being columns [8n, 8n + 8). ``accumulate`` 0 overwrites D.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n" CXR_WGMMA_M64N64K16
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : CXR_WGMMA_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(kTransB));
}

// The same step with A read from shared memory too, both operands K-major
// swizzled tiles (rows are m or n, the 128 bytes run along k).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n" CXR_WGMMA_M64N64K16
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : CXR_WGMMA_ACC(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
#undef CXR_WGMMA_ACC
#undef CXR_WGMMA_M64N64K16

// The 64 x 64 x 64 products of a warpgroup on swizzled tiles, four 16-deep
// steps each, asynchronous: the caller fences before, commits after and
// waits before it reads ``acc``.
//
// tile_mma_ss: acc = A B^T, both operands tiles in shared memory; A's rows
// are the product's 64 rows, B's rows its 64 columns (S^T = K Q^T).
// ``accumulate`` adds to acc instead (the second 64-column chunk of a head
// dim above 64), and only the first ``ksteps`` (block-uniform) 16-deep
// steps run: those past the head dim would add zeros.
__device__ __forceinline__ void tile_mma_ss(float (&acc)[8][4], uint32_t a_tile,
                                            uint32_t b_tile,
                                            bool accumulate = false,
                                            int ksteps = 4) {
  const uint64_t da = wgmma_desc(a_tile), db = wgmma_desc(b_tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < ksteps)
      wgmma_m64n64k16_ss(acc, da + 2 * kk, db + 2 * kk,
                         kk == 0 && !accumulate ? 0 : 1);
}

// tile_mma_rs: A is 64 x 64 with this warp's 16 rows as fragments ``a``, B
// one tile. kTransB false: acc = A tile^T, the tile's rows are the
// product's columns (S = Q K^T with the K tile). kTransB true:
// acc += A tile, the tile's rows are the k index (dQ += dS K); ``rows``
// (block-uniform) is the number of leading tile rows that hold data, below
// 64 only in the ragged last tile of a sequence, and only the 16-deep steps
// that reach them run.
template <bool kTransB>
__device__ __forceinline__ void tile_mma_rs(float (&acc)[8][4],
                                            const uint32_t (&a)[4][4],
                                            uint32_t tile,
                                            int rows = kTileRows) {
  const uint64_t desc = wgmma_desc(tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (!kTransB || kk * 16 < rows)
      wgmma_m64n64k16<kTransB ? 1 : 0>(
          acc, a[kk], desc + ((kTransB ? kk * 2048 : kk * 32) >> 4),
          kTransB || kk > 0 ? 1 : 0);
}

// ---------------------------------------------------------------------------
// int8 tiles for the s8 wgmma of the int8 kernel. A row of 128 int8 values
// is 128 bytes, so a [rows x 128] K-major int8 tile under the 128-byte
// swizzle has the geometry of the bf16 tiles above (swizzled, wgmma_desc),
// and a k32 step is 32 bytes deep as a bf16 k16 step is: step kk starts at
// descriptor + 2 kk. wgmma takes 8-bit operands K-major only.
// ---------------------------------------------------------------------------

// Starts the copies of a [kRows x 128-byte] int8 tile from ``src`` (its
// first row and first byte of k; rows ``ld`` bytes apart) into the swizzled
// tile at ``dst``, by the kThreads threads of the block: rows at or past
// ``rows`` and bytes at or past ``kbytes`` of a row arrive as zeros and are
// not read.
template <int kRows, int kThreads>
__device__ __forceinline__ void copy_s8_tile_async(uint32_t dst,
                                                   const int8_t* src,
                                                   long long ld, int rows,
                                                   int kbytes) {
  static_assert(kRows * 8 % kThreads == 0, "whole 16-byte chunks a thread");
#pragma unroll
  for (int j = 0; j < kRows * 8 / kThreads; ++j) {
    const int i = threadIdx.x + kThreads * j, r = i >> 3, c = i & 7;
    const bool valid = r < rows && c * 16 < kbytes;
    cp_async_16(dst + swizzled(r, c), src + (valid ? r * ld + c * 16 : 0),
                valid);
  }
}

// The compiler keeps every ordinary read and write of an int32 accumulator
// on its side of this point (acc_fence for the s8 products).
__device__ __forceinline__ void acc_fence(int (&acc)[16][4]) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(acc[n][e])::"memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait(int (&acc)[16][4]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
  acc_fence(acc);
}

#define CXR_ACC4(d, n) \
  "+r"(d[n][0]), "+r"(d[n][1]), "+r"(d[n][2]), "+r"(d[n][3])
// One asynchronous m64n128k32 step of a warpgroup, int8 in, int32
// accumulated: D += A B^T with A (64 rows) and B (128 rows) K-major
// swizzled int8 tiles read through their descriptors. D is the warp's
// 16 x 128 accumulator in the f32 layout: d[n] holds rows g and g + 8 at
// columns 8n + 2t, 8n + 2t + 1 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[16][4],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : CXR_ACC4(d, 0), CXR_ACC4(d, 1), CXR_ACC4(d, 2), CXR_ACC4(d, 3),
        CXR_ACC4(d, 4), CXR_ACC4(d, 5), CXR_ACC4(d, 6), CXR_ACC4(d, 7),
        CXR_ACC4(d, 8), CXR_ACC4(d, 9), CXR_ACC4(d, 10), CXR_ACC4(d, 11),
        CXR_ACC4(d, 12), CXR_ACC4(d, 13), CXR_ACC4(d, 14), CXR_ACC4(d, 15)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
#undef CXR_ACC4

// acc += A B^T over one 128-byte-deep k tile: the first ``ksteps`` (1 to
// 4, block-uniform) k32 steps, asynchronous (the caller fences before,
// commits after and waits before it reads ``acc``).
__device__ __forceinline__ void tile_mma_s8(int (&acc)[16][4], uint32_t a_tile,
                                            uint32_t b_tile, int ksteps) {
  const uint64_t da = wgmma_desc(a_tile), db = wgmma_desc(b_tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < ksteps) wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk);
}

}  // namespace cxr
