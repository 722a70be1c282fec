// LayerNorm forward over the last dim: y = (x - mean) * rsqrt(var + eps) *
// scale + bias, f32 mean and centered variance, output in x's dtype
// (layer_norm.cuh has what it shares with the backward, layer_norm_bwd.cu).
// Replaces the TPU kernel chestxray_vit_tpu/ops/layer_norm.py
// `_ln_fwd_kernel` (launched by `_forward_pallas`), which normalises
// 256-row blocks resident in VMEM after padding the rows to a block
// multiple.
//
// The rungs (ln_fwd, a row of up to 2048 columns in whole 16-byte
// vectors): a warp owns a row at a time, reads it once with 16-byte vector
// loads into registers, reduces the sum and then the centered sum of
// squares with warp shuffles (the two-pass form of `_ln_fwd_kernel`, not
// E[x^2] - mean^2), and writes the row once. The registers are sized to D
// (template V), the warp's scale and bias columns are read once into
// registers as 16-byte vectors, and each warp walks rows with the next
// row's loads issued before the current row's reductions. An f32 row of
// more than 1024 columns (ViT-H/14's 1280) takes up to sixteen vectors a
// lane, and then its row, next row, scale and bias no longer fit in
// registers: those rungs (kBig) keep one row a warp in flight and read
// scale and bias where they are used (L1 hits: every warp reads the same).
//
// Any other D (ln_fwd_any, the layout of ln_bwd_any): a row off the
// vector of up to 256 elements is owned by a warp, one of up to 4096 by a
// block, a row of whole vectors past 2048 by a block (bf16 D <= 8192, f32
// D <= 4096). Each row is read from device memory once into registers as
// raw words, the next row's loads are issued before the current row's two
// reductions (a warp's butterfly, no barrier; in the block form then the
// warps' partials through one of two shared buffers in turn, one barrier
// each), and scale and bias are read once into registers, as 16-byte
// vectors where the row is. Wider rows take ln_fwd_rowloop (a block a row
// read once a pass from L1 / L2, scale and bias as vectors where the row
// is). What bounds every form on an H100: bandwidth (a [36 * 577, 768]
// bf16 call moves 32 MB in and 32 MB out), so the design goal is one read
// of x and one write of y, with enough bytes in flight to cover the
// memory's latency.

#include "layer_norm.cuh"

namespace {

using namespace cxr::ln;
using cxr::warp_sum;

constexpr int kFwdWarps = 4;         // forward: warps of a block

// V = 16-byte vectors per lane (ceil(D / E / 32)), so that a row, the next
// row, the scale and the bias all stay in registers sized to D, as packed
// words (a bf16 value is widened where it is used). Each warp walks rows (a
// grid of one wave of resident blocks): scale and bias are read once, and
// the next row's loads are issued before the current row's two reductions,
// so two rows a warp are in flight.
template <typename T, typename W, int V>
__global__ void __launch_bounds__(32 * kFwdWarps)
ln_fwd(const T* __restrict__ x, const W* __restrict__ scale,
       const W* __restrict__ bias, T* __restrict__ y, long long rows, int D,
       float eps) {
  constexpr int E = 16 / sizeof(T);               // elements per vector
  constexpr int kW = E * sizeof(W) / 4;           // words of E parameters
  constexpr bool kBig = V > kMaxVecs;  // scale, bias read where used
  constexpr int kHeld = kBig ? 1 : V;  // their vectors held in registers
  const int lane = threadIdx.x & 31;
  const int nvec = D / E;

  uint32_t sw[kHeld][kW], bw[kHeld][kW];
  if constexpr (!kBig) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        load_words(scale + vi * E, sw[i]);
        load_words(bias + vi * E, bw[i]);
      }
    }
  }

  const long long step = static_cast<long long>(gridDim.x) * kFwdWarps;
  long long row =
      static_cast<long long>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5);
  uint32_t cur[V][4];
  auto fetch = [&](long long r, uint32_t (&raw)[V][4]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) load_words(x + r * D + vi * E, raw[i]);
    }
  };
  if (row < rows) fetch(row, cur);
  for (; row < rows; row += step) {
    uint32_t nxt[kBig ? 1 : V][4];
    if constexpr (!kBig)
      if (row + step < rows) fetch(row + step, nxt);

    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + i * 32 < nvec)
#pragma unroll
        for (int j = 0; j < E; ++j) sum += elem<T>(cur[i], j);
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + i * 32 < nvec)
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float d = elem<T>(cur[i], j) - mean;
          sq += d * d;
        }
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
    T* yr = y + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        float o[E];
        if constexpr (kBig) {
          uint32_t swb[kW], bwb[kW];
          load_words(scale + vi * E, swb);
          load_words(bias + vi * E, bwb);
#pragma unroll
          for (int j = 0; j < E; ++j)
            o[j] = (elem<T>(cur[i], j) - mean) * rstd * elem<W>(swb, j) +
                   elem<W>(bwb, j);
        } else {
#pragma unroll
          for (int j = 0; j < E; ++j)
            o[j] = (elem<T>(cur[i], j) - mean) * rstd * elem<W>(sw[i], j) +
                   elem<W>(bw[i], j);
        }
        store_vec(yr + vi * E, o);
      }
    }
    if constexpr (kBig) {
      if (row + step < rows) fetch(row + step, cur);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int w = 0; w < 4; ++w) cur[i][w] = nxt[i][w];
    }
  }
}

// The any-D forward's layout: the row in hand and the next (raw words),
// the scale and the bias of the thread's pieces, in registers.
template <typename T, typename W, bool kVec, bool kWarpRow, int V>
struct AnyFwd : AnyRows<T, kVec, kWarpRow, V> {
  using Base = AnyRows<T, kVec, kWarpRow, V>;
  using Q = Params<W, Base::kE>;
  static constexpr int kRegs =
      2 * V * Base::R::kWords + 2 * V * Q::kWords;
  static constexpr int kMinBlocks = kRegs < 32 ? 4 : kRegs <= 96 ? 2 : 1;
};

// Rows walked by warps (kWarpRow) or by whole blocks, each read from
// device memory once into registers as raw words, with the next row's
// loads issued before the current row's two reductions (a warp's
// butterfly; in the block form then the warps' partials through one of
// two buffers in turn, one barrier each); the scale and bias of a
// thread's pieces read once into registers, as 16-byte vectors where the
// row is.
template <typename T, typename W, bool kVec, bool kWarpRow, int V>
__global__ void __launch_bounds__(
    kAnyThreads, (AnyFwd<T, W, kVec, kWarpRow, V>::kMinBlocks))
ln_fwd_any(const T* __restrict__ x, const W* __restrict__ scale,
           const W* __restrict__ bias, T* __restrict__ y, long long rows,
           int D, float eps) {
  using L = AnyFwd<T, W, kVec, kWarpRow, V>;
  using R = typename L::R;
  using Q = typename L::Q;
  static_assert(!(kWarpRow && kVec), "a warp a row off the vector only");
  constexpr int E = L::kE, kWd = R::kWords, kPw = Q::kWords;
  // the block form's two buffers of the warps' partial sums
  __shared__ float red[2][kAnyWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int me = kWarpRow ? lane : threadIdx.x;  // within the row's threads
  const int row_threads = kWarpRow ? 32 : static_cast<int>(blockDim.x);
  const int nw = blockDim.x >> 5;  // warps of the block
  const int np = D / E;

  const long long step =
      kWarpRow ? static_cast<long long>(gridDim.x) * kAnyWarps : gridDim.x;
  long long row = kWarpRow
                      ? static_cast<long long>(blockIdx.x) * kAnyWarps + warp
                      : static_cast<long long>(blockIdx.x);
  uint32_t cur[V][kWd];
  auto fetch = [&](long long r, uint32_t (&w)[V][kWd]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) R::load(x + r * D, p, w[i]);
    }
  };
  if (row < rows) fetch(row, cur);  // in flight while the scale is read
  uint32_t sw[V][kPw], bw[V][kPw];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int p = me + i * row_threads;
    if (p < np) {
      Q::load(scale, p, sw[i]);
      Q::load(bias, p, bw[i]);
    }
  }

  // A sum over the row's threads, in a fixed order: the barrier of one
  // reduction orders the reads of the buffer before it against the writes
  // of the one after it.
  int buf = 0;
  auto row_sum = [&](float a) {
    a = warp_sum(a);
    if constexpr (!kWarpRow) {
      if (lane == 0) red[buf][warp] = a;
      __syncthreads();
      a = 0.f;
#pragma unroll
      for (int w = 0; w < kAnyWarps; ++w)
        if (w < nw) a += red[buf][w];
      buf ^= 1;
    }
    return a;
  };

  for (; row < rows; row += step) {  // uniform over the row's threads
    uint32_t nxt[V][kWd];
    if (row + step < rows) fetch(row + step, nxt);

    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (me + i * row_threads < np)
#pragma unroll
        for (int j = 0; j < E; ++j) sum += R::at(cur[i], j);
    const float mean = row_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (me + i * row_threads < np)
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float d = R::at(cur[i], j) - mean;
          sq += d * d;
        }
    const float rstd = rsqrtf(row_sum(sq) / D + eps);
    T* yr = y + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        float o[E];
#pragma unroll
        for (int j = 0; j < E; ++j)
          o[j] = (R::at(cur[i], j) - mean) * rstd * Q::at(sw[i], j) +
                 Q::at(bw[i], j);
        R::store(yr, p, o);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int w = 0; w < kWd; ++w) cur[i][w] = nxt[i][w];
  }
}

// Past the widths whose rows fit in registers (ln_fwd_any's), a block a
// row read from L1 / L2 once a pass (the sum, the centered sum of
// squares, the output), the scale and bias read as 16-byte vectors where
// the row is.
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kAnyThreads)
ln_fwd_rowloop(const T* __restrict__ x, const W* __restrict__ scale,
               const W* __restrict__ bias, T* __restrict__ y,
               long long rows, int D, float eps) {
  using P = Piece<T, kVec>;
  constexpr int E = P::kE;
  using Q = Params<W, E>;
  __shared__ float red[2 * kAnyWarps];
  const int np = D / E;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    float sum = 0.f, unused = 0.f;
    for (int p = threadIdx.x; p < np; p += kAnyThreads) {
      float v[E];
      P::load(xr, p, v);
#pragma unroll
      for (int j = 0; j < E; ++j) sum += v[j];
    }
    block_sum2(sum, unused, red);
    const float mean = sum / D;
    float sq = 0.f;
    unused = 0.f;
    for (int p = threadIdx.x; p < np; p += kAnyThreads) {
      float v[E];
      P::load(xr, p, v);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float d = v[j] - mean;
        sq += d * d;
      }
    }
    block_sum2(sq, unused, red);
    const float rstd = rsqrtf(sq / D + eps);
    T* yr = y + row * D;
    for (int p = threadIdx.x; p < np; p += kAnyThreads) {
      float v[E];
      uint32_t sw[Q::kWords], bw[Q::kWords];
      P::load(xr, p, v);
      Q::load(scale, p, sw);
      Q::load(bias, p, bw);
#pragma unroll
      for (int j = 0; j < E; ++j)
        v[j] = (v[j] - mean) * rstd * Q::at(sw, j) + Q::at(bw, j);
      P::store(yr, p, v);
    }
  }
}

// One wave: as many blocks as fit on the card at once, fewer when there
// are fewer rows.
template <typename T, typename W, int V>
cudaError_t launch_fwd_v(const void* x, const void* s, const void* b, void* y,
                         long long rows, int d, float eps, int device,
                         cudaStream_t st) {
  static int cache[64] = {};
  int wave = 0;
  cudaError_t err =
      wave_of(ln_fwd<T, W, V>, 32 * kFwdWarps, 0, device, cache, &wave);
  if (err != cudaSuccess) return err;
  const long long need = (rows + kFwdWarps - 1) / kFwdWarps;
  const unsigned blocks = static_cast<unsigned>(need < wave ? need : wave);
  ln_fwd<T, W, V><<<blocks, 32 * kFwdWarps, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(s),
      static_cast<const W*>(b), static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

// A forward call off the rungs.
struct FwdCall {
  const void *x, *scale, *bias;
  void* y;
  long long rows;
  int d;
  float eps;
  int device;
  cudaStream_t st;
};

// `kernel` on one wave of blocks of `threads` (its blocks resident at
// once, found once by the block's warps and device into `cache`), fewer
// for fewer rows (`per_block` rows a block's first turn).
template <typename T, typename W, typename K>
cudaError_t launch_fwd_wave(K* kernel, const FwdCall& c, int threads,
                            long long per_block,
                            int (&cache)[kAnyWarps][64]) {
  int wave = 0;
  cudaError_t err =
      wave_of(kernel, threads, 0, c.device, cache[threads / 32 - 1], &wave);
  if (err != cudaSuccess) return err;
  const long long need = (c.rows + per_block - 1) / per_block;
  const unsigned blocks = static_cast<unsigned>(need < wave ? need : wave);
  kernel<<<blocks, threads, 0, c.st>>>(
      static_cast<const T*>(c.x), static_cast<const W*>(c.scale),
      static_cast<const W*>(c.bias), static_cast<T*>(c.y), c.rows, c.d,
      c.eps);
  return cudaGetLastError();
}

template <typename T, typename W, bool kVec, bool kWarpRow, int V>
cudaError_t launch_fwd_any(const FwdCall& c) {
  static int cache[kAnyWarps][64] = {};
  return launch_fwd_wave<T, W>(
      ln_fwd_any<T, W, kVec, kWarpRow, V>, c,
      AnyFwd<T, W, kVec, kWarpRow, V>::threads(c.d),
      kWarpRow ? kAnyWarps : 1, cache);
}

template <typename T, typename W, bool kVec>
cudaError_t launch_fwd_rowloop(const FwdCall& c) {
  static int cache[kAnyWarps][64] = {};
  return launch_fwd_wave<T, W>(ln_fwd_rowloop<T, W, kVec>, c, kAnyThreads,
                               1, cache);
}

// Any D off the rungs, as the backward: whole 16-byte vectors (D past
// 2048) take a block a row, 2 to 4 vectors a thread (bf16 D <= 8192, f32
// D <= 4096); a D off the vector takes a warp a row up to 256 elements (1,
// 2, 4 or 8 a lane), a block a row up to 4096 (2, 4, 8 or 16 a thread);
// wider rows ln_fwd_rowloop.
template <typename T, typename W>
cudaError_t launch_fwd_off_rungs(const FwdCall& c) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  if (c.d % E == 0) {
    const int v = (c.d / E + kAnyThreads - 1) / kAnyThreads;
    if (v <= 2) return launch_fwd_any<T, W, true, false, 2>(c);
    if (v <= 3) return launch_fwd_any<T, W, true, false, 3>(c);
    if (v <= 4) return launch_fwd_any<T, W, true, false, 4>(c);
    return launch_fwd_rowloop<T, W, true>(c);
  }
  if (c.d <= 32 * 8) {
    const int v = (c.d + 31) / 32;
    if (v <= 1) return launch_fwd_any<T, W, false, true, 1>(c);
    if (v <= 2) return launch_fwd_any<T, W, false, true, 2>(c);
    if (v <= 4) return launch_fwd_any<T, W, false, true, 4>(c);
    return launch_fwd_any<T, W, false, true, 8>(c);
  }
  const int v = (c.d + kAnyThreads - 1) / kAnyThreads;
  if (v <= 2) return launch_fwd_any<T, W, false, false, 2>(c);
  if (v <= 4) return launch_fwd_any<T, W, false, false, 4>(c);
  if (v <= 8) return launch_fwd_any<T, W, false, false, 8>(c);
  if (v <= 16) return launch_fwd_any<T, W, false, false, 16>(c);
  return launch_fwd_rowloop<T, W, false>(c);
}

template <typename T, typename W>
cudaError_t launch_fwd(const void* x, const void* s, const void* b, void* y,
                       long long rows, int d, float eps, int device,
                       cudaStream_t st) {
  if (!on_rungs<T>(d))
    return launch_fwd_off_rungs<T, W>(
        FwdCall{x, s, b, y, rows, d, eps, device, st});
  const int v = (d / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
#define CXR_LN_FWD(V) \
  if (v <= V) return launch_fwd_v<T, W, V>(x, s, b, y, rows, d, eps, device, st);
  CXR_LN_FWD(1)
  CXR_LN_FWD(2)
  CXR_LN_FWD(3)
  CXR_LN_FWD(4)
  CXR_LN_FWD(6)
  CXR_LN_FWD(8)
  if constexpr (sizeof(T) == 4) {  // f32 rows of more than 1024 columns
    CXR_LN_FWD(12)
    CXR_LN_FWD(16)
  }
#undef CXR_LN_FWD
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x and y are contiguous [rows, d]
// from a 16-byte aligned address, scale and bias [d] 16-byte aligned; any
// d >= 1.
extern "C" int cxr_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, long long rows,
                                  int d, float eps, int x_dtype, int w_dtype,
                                  int device, void* stream) {
  if (bad_shape(rows, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    err = launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, y, rows, d,
                                                   eps, device, st);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch_fwd<__nv_bfloat16, float>(x, scale, bias, y, rows, d, eps,
                                           device, st);
  else if (x_dtype == 0 && w_dtype == 0)
    err = launch_fwd<float, float>(x, scale, bias, y, rows, d, eps, device, st);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch_fwd<float, __nv_bfloat16>(x, scale, bias, y, rows, d, eps,
                                           device, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
