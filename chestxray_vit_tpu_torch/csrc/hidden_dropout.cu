// Hidden dropout: y = keep ? x / (1 - rate) : 0 in x's dtype over a
// contiguous [B, S, D] activation, the keep mask a counter hash of each
// element's global index, so no mask is stored: the backward is the same
// kernel on the upstream gradient, and a remat recompute, a data-parallel
// rank's slice of the global batch, the card and the CPU all draw the same
// bits from the same seed.
//
// No Pallas counterpart: the JAX package draws `jax.random.bernoulli` at the
// global shape in XLA (chestxray_vit_tpu/models/vit.py `_dropout`). The
// hash is the attention dropout's (`cxr::fmix32`, the murmur3 finalizer of
// the TPU kernels' `_keep_mask`): element (b, t, c) of a call whose first
// row is global batch row row_base hashes the counter
// ((row_base + b) * S + t) * D + c (uint32, wrapping), which is
// row_base * S * D + its flat index, XOR the mixed seed, and is kept when
// that reaches the threshold min(rate * 2^32, 2^32 - 1). The survivors are
// divided by 1 - rate in f32 (IEEE division, as the plain version divides)
// and rounded once to x's dtype.
//
// What bounds it on an H100: bandwidth. A [36 * 577, 768] bf16 call reads
// 32 MB and writes 32 MB with about 20 integer and float operations an
// element, so each thread moves 16-byte vectors (8 bf16 or 4 f32 elements)
// in a grid-stride loop, hashing them in registers between the load and
// the store.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // a few waves; the loop strides

template <typename T>
__device__ __forceinline__ T drop_one(T x, uint32_t counter,
                                      uint32_t seed_mix, uint32_t threshold,
                                      float keep_prob) {
  const bool keep = cxr::fmix32(counter ^ seed_mix) >= threshold;
  return cxr::from_f32<T>(keep ? __fdiv_rn(cxr::to_f32(x), keep_prob) : 0.f);
}

// kVec: x and y 16-byte aligned, whole vectors loaded and stored at once
// (the tail past the last whole vector element by element).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    hidden_dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                          long long n, uint32_t base, uint32_t seed_mix,
                          uint32_t threshold, float keep_prob) {
  constexpr int V = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * V;
  for (long long i =
           (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
       i < n; i += stride) {
    const uint32_t c0 = base + static_cast<uint32_t>(i);
    if (kVec && i + V <= n) {
      alignas(16) T v[V];
      *reinterpret_cast<uint4*>(v) =
          __ldg(reinterpret_cast<const uint4*>(x + i));
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = drop_one(v[j], c0 + j, seed_mix, threshold, keep_prob);
      *reinterpret_cast<uint4*>(y + i) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int j = 0; j < V && i + j < n; ++j)
        y[i + j] = drop_one(x[i + j], c0 + j, seed_mix, threshold, keep_prob);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, uint32_t base,
                   uint32_t seed_mix, uint32_t threshold, float keep_prob,
                   cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long per_block = kThreads * (vec ? 16 / sizeof(T) : 1);
  const long long need = (n + per_block - 1) / per_block;
  const unsigned blocks =
      static_cast<unsigned>(need < kMaxBlocks ? need : kMaxBlocks);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec)
    hidden_dropout_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        xt, yt, n, base, seed_mix, threshold, keep_prob);
  else
    hidden_dropout_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        xt, yt, n, base, seed_mix, threshold, keep_prob);
  return cudaGetLastError();
}

}  // namespace

// x and y contiguous, n elements of dtype (0 = float32, 1 = bfloat16);
// row_elems = S * D, the elements of one batch row; row_base the global
// batch row of the call's first row. seed_mix and threshold are the
// attention dropout's (see cxr::Dropout); keep_prob is 1 - rate.
extern "C" int cxr_hidden_dropout(const void* x, void* y, long long n,
                                  long long row_elems, unsigned row_base,
                                  unsigned seed_mix, unsigned threshold,
                                  float keep_prob, int dtype, int device,
                                  void* stream) {
  if (n < 0 || row_elems <= 0 || !(keep_prob > 0.f && keep_prob <= 1.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t base = row_base * static_cast<uint32_t>(row_elems);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(x, y, n, base, seed_mix, threshold, keep_prob, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, y, n, base, seed_mix, threshold,
                                keep_prob, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
