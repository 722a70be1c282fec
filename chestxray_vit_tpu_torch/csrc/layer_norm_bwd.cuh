// The LayerNorm backward's units (layer_norm_bwd.cu: the rungs and
// ln_bwd_any; layer_norm_bwd_wide.cu: rows past ln_bwd_any's widths) share
// the call, the any-D layout, and the column pass that adds the
// workspace's [n_blocks, 2, D] partials.

#pragma once

#include "layer_norm.cuh"

namespace cxr {
namespace ln {

// The any-D backward's layout: the rows of AnyRows, and in registers the
// row in hand and the next (x and dy, raw) and the thread's sums.
template <typename T, typename W, bool kVec, bool kWarpRow, int V>
struct AnyBwd : AnyRows<T, kVec, kWarpRow, V> {
  using Base = AnyRows<T, kVec, kWarpRow, V>;
  using R = typename Base::R;
  static constexpr int kE = Base::kE;
  static constexpr int kRegs = 4 * V * R::kWords + 2 * V * kE;
  static constexpr int kMinBlocks =
      kWarpRow ? (kRegs <= 32 ? 4 : 3) : kRegs <= 96 ? 2 : 1;
  __host__ __device__ static constexpr int scale_bytes(int d) {
    return (d * static_cast<int>(sizeof(W)) + 15) / 16 * 16;
  }
  // the scale, then kWarpRow: the warps' sums, [warp][2 V kE][32]
  // lane-minor; else two buffers of the warps' two partial sums
  static constexpr int kAux =
      kWarpRow ? kAnyWarps * 2 * V * kE * 32 * 4 : 2 * 2 * kAnyWarps * 4;
  __host__ __device__ static constexpr int smem(int d) {
    return scale_bytes(d) + kAux;
  }
};

// A backward call, or with `wave` set only the number of its blocks that
// are resident at once.
struct BwdCall {
  const void *x, *scale, *dy;
  void *dx, *dscale, *dbias;
  float* part;
  long long rows;
  int d;
  float eps;
  int n_blocks, device;
  cudaStream_t st;
  int* wave;
};

// Past ln_bwd_any's widths (layer_norm_bwd_wide.cu): a cluster of blocks a
// row of whole vectors, or the two-pass form; with `wave` set, its wave.
template <typename T, typename W, bool kVec>
cudaError_t run_bwd_wide(const BwdCall& c);

}  // namespace ln
}  // namespace cxr

namespace {

constexpr int kColWarps = 32;  // column pass: warps of a block

// dscale and dbias from the [n_blocks, 2 * D] partials: a block owns 32
// columns; warp w sums partials w, w + kColWarps, ... in order (each a
// 128-byte row piece), then warp 0 adds the warps' sums in warp order.
template <typename W>
__global__ void __launch_bounds__(32 * kColWarps)
ln_bwd_cols(const float* __restrict__ part, int n_blocks, int D,
            W* __restrict__ dscale, W* __restrict__ dbias) {
  __shared__ float s_sum[kColWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < 2 * D) {
#pragma unroll 4
    for (int b = warp; b < n_blocks; b += kColWarps)
      acc += part[static_cast<long long>(b) * 2 * D + c];
  }
  s_sum[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < 2 * D) {
    float t = s_sum[0][lane];
#pragma unroll
    for (int w = 1; w < kColWarps; ++w) t += s_sum[w][lane];
    if (c < D)
      dscale[c] = cxr::from_f32<W>(t);
    else
      dbias[c - D] = cxr::from_f32<W>(t);
  }
}

// The column pass over a backward's n_blocks partials.
template <typename W>
cudaError_t launch_cols(const cxr::ln::BwdCall& c) {
  ln_bwd_cols<W><<<(2 * c.d + 31) / 32, 32 * kColWarps, 0, c.st>>>(
      c.part, c.n_blocks, c.d, static_cast<W*>(c.dscale),
      static_cast<W*>(c.dbias));
  return cudaGetLastError();
}

}  // namespace
