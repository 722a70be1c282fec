// LayerNorm over the last dim, f32 statistics: what the forward
// (layer_norm.cu) and the backward (layer_norm_bwd.cu) share. Two
// translation units, so that nvcc builds them at once.
//
// Rows are B * S with no padding, x and the outputs contiguous from
// 16-byte aligned addresses. A row of up to 2048 columns in whole 16-byte
// vectors takes the register rungs (a warp a row, the registers sized to
// D); any other D takes the any-D kernels, whose rows are laid out alike in
// both directions (AnyRows): off the vector a warp a row up to 256 elements
// (1, 2, 4 or 8 a lane) and a block a row up to 4096 (2, 4, 8 or 16 a
// thread); whole vectors past 2048 a block a row, 2 to 4 vectors a thread
// (bf16 D <= 8192, f32 D <= 4096); wider rows a block a row read once a
// pass (the rowloop kernels). What bounds both directions on an H100 is
// the memory's bandwidth: ~10-20 flops an element, far below the card's
// ~295 flop/byte ridge.

#pragma once

#include "common.cuh"

namespace cxr {
namespace ln {

constexpr int kMaxVecs = 8;          // vectors per lane held with the next row
constexpr int kMaxD = 2048;          // the widest row the rungs take

// Element j of a vector of X held as 32-bit words (f32: one a word; bf16:
// two, the lower address in the low half), as a float (exact).
template <typename X>
__device__ __forceinline__ float elem(const uint32_t* w, int j) {
  if constexpr (sizeof(X) == 4)
    return __uint_as_float(w[j]);
  else
    return (j & 1) ? cxr::bf16_hi(w[j >> 1]) : cxr::bf16_lo(w[j >> 1]);
}

// The kWords 32-bit words at p (8, 16 or 32 bytes, as aligned), in 16-byte
// loads or one 8-byte load.
template <int kWords>
__device__ __forceinline__ void load_words(const void* p,
                                           uint32_t (&w)[kWords]) {
  if constexpr (kWords == 2) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x;
    w[1] = r.y;
  } else {
    static_assert(kWords % 4 == 0, "8, 16 or 32 bytes");
#pragma unroll
    for (int h = 0; h < kWords / 4; ++h) {
      const uint4 r = reinterpret_cast<const uint4*>(p)[h];
      w[4 * h] = r.x;
      w[4 * h + 1] = r.y;
      w[4 * h + 2] = r.z;
      w[4 * h + 3] = r.w;
    }
  }
}

// o[0 .. 16 / sizeof(T)) rounded to T, stored as one 16-byte vector at p.
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* o) {
  uint4 out;
  if constexpr (sizeof(T) == 4)
    out = make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                     __float_as_uint(o[2]), __float_as_uint(o[3]));
  else
    out = make_uint4(cxr::pack_bf16x2(o[0], o[1]), cxr::pack_bf16x2(o[2], o[3]),
                     cxr::pack_bf16x2(o[4], o[5]), cxr::pack_bf16x2(o[6], o[7]));
  *reinterpret_cast<uint4*>(p) = out;
}

// Two warp sums in one butterfly.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

constexpr int kAnyThreads = 256;
constexpr int kAnyWarps = kAnyThreads / 32;

// Piece p of a row: with kVec a 16-byte vector (E elements), else one
// element; as raw 32-bit words (the element in the low bits of a word) or
// as floats.
template <typename T, bool kVec>
struct Piece {
  static constexpr int kE = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  static constexpr int kWords = kVec ? 4 : 1;
  __device__ __forceinline__ static void load(const T* row, int p,
                                              uint32_t (&w)[kWords]) {
    if constexpr (kVec)
      load_words(row + p * kE, w);
    else if constexpr (sizeof(T) == 4)
      w[0] = __float_as_uint(row[p]);
    else
      w[0] = static_cast<uint32_t>(__bfloat16_as_ushort(row[p]));
  }
  __device__ __forceinline__ static float at(const uint32_t (&w)[kWords],
                                             int j) {
    if constexpr (kVec)
      return elem<T>(w, j);
    else if constexpr (sizeof(T) == 4)
      return __uint_as_float(w[0]);
    else
      return cxr::bf16_lo(w[0]);
  }
  __device__ __forceinline__ static void load(const T* row, int p,
                                              float (&v)[kE]) {
    uint32_t w[kWords];
    load(row, p, w);
#pragma unroll
    for (int j = 0; j < kE; ++j) v[j] = at(w, j);
  }
  __device__ __forceinline__ static void store(T* row, int p,
                                               const float (&v)[kE]) {
    if constexpr (kVec)
      store_vec(row + p * kE, v);
    else
      row[p] = from_f32<T>(v[0]);
  }
};

// The block's sums of a and b (every thread gets them), in a fixed order:
// warp sums, then warp 0 ... kAnyWarps - 1. ``red`` holds 2 * kAnyWarps
// floats; every thread must call it.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  warp_sum2(a, b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's reads of red are done
  if (lane == 0) {
    red[warp] = a;
    red[kAnyWarps + warp] = b;
  }
  __syncthreads();
  a = b = 0.f;
#pragma unroll
  for (int w = 0; w < kAnyWarps; ++w) {
    a += red[w];
    b += red[kAnyWarps + w];
  }
}

// The kE values of W at piece p (columns p kE ...) as raw 32-bit words,
// read once and widened where they are used; one element (kE == 1) is
// held widened to f32, as its bits.
template <typename W, int kE>
struct Params {
  static constexpr int kWords =
      kE == 1 ? 1 : kE * static_cast<int>(sizeof(W)) / 4;
  __device__ __forceinline__ static void load(const W* s, int p,
                                              uint32_t (&w)[kWords]) {
    if constexpr (kE == 1)
      w[0] = __float_as_uint(cxr::to_f32(s[p]));
    else
      load_words(s + p * kE, w);
  }
  __device__ __forceinline__ static float at(const uint32_t (&w)[kWords],
                                             int j) {
    if constexpr (kE == 1)
      return __uint_as_float(w[0]);
    else
      return elem<W>(w, j);
  }
};

// The any-D kernels' rows: kWarpRow, a warp a row (rows of at most 32 V
// elements off the vector), 256 threads a block; else a block a row, V
// pieces a thread, as many whole warps as that takes (at most 256 threads:
// 160 for a bf16 row of 2560, so that several blocks fit an SM).
template <typename T, bool kVec, bool kWarpRow, int V>
struct AnyRows {
  using R = Piece<T, kVec>;
  static constexpr int kE = R::kE;
  static constexpr int kMaxD = (kWarpRow ? 32 : kAnyThreads) * V * kE;
  __host__ __device__ static constexpr int threads(int d) {
    return kWarpRow ? kAnyThreads
                    : ((d / kE + V - 1) / V + 31) / 32 * 32;
  }
};

// Blocks of `kernel` resident on the card at once, with `smem` bytes of
// dynamic shared memory (allowed first), found once per kernel and device
// into `cache`.
template <typename K>
cudaError_t wave_of(K* kernel, int threads, int smem, int device,
                    int (&cache)[64], int* blocks) {
  if (device < 0 || device >= 64) return cudaErrorInvalidValue;
  if (cache[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    cache[device] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  *blocks = cache[device];
  return cudaSuccess;
}

// Whether d takes the rungs (a whole number of 16-byte vectors, at most
// kMaxD) or the any-D kernels.
template <typename T>
bool on_rungs(int d) {
  return d <= kMaxD && d % (16 / static_cast<int>(sizeof(T))) == 0;
}

inline bool bad_shape(long long rows, int d) { return rows <= 0 || d <= 0; }

}  // namespace ln
}  // namespace cxr
