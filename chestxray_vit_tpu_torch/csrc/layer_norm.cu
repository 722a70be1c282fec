// LayerNorm over the last dim, forward and backward, f32 statistics.
//
// Forward: y = (x - mean) * rsqrt(var + eps) * scale + bias, f32 mean and
// centered variance, output in x's dtype. Replaces the TPU kernel
// chestxray_vit_tpu/ops/layer_norm.py `_ln_fwd_kernel` (launched by
// `_forward_pallas`), which normalises 256-row blocks resident in VMEM after
// padding the rows to a block multiple. Here a warp owns a row at a time:
// it reads the row once with 16-byte vector loads into registers, reduces
// the sum and then the centered sum of squares with warp shuffles (the
// two-pass form of `_ln_fwd_kernel`, not E[x^2] - mean^2), and writes the
// row once. Rows are B * S with no padding. The registers are sized to D
// (template V, dispatched from D as the backward is), the warp's scale and
// bias columns are read once into registers as 16-byte vectors, and each
// warp walks rows with the next row's loads issued before the current
// row's reductions.
//
// Backward: dx = (g - mean(g) - x_hat * mean(g * x_hat)) * rstd with
// g = dy * scale, and dscale = sum over rows of dy * x_hat, dbias = sum of
// dy. Replaces `_ln_bwd_kernel` (launched by `_bwd_pallas`), which sums the
// parameter gradients across a *sequential* row-block grid in VMEM scratch.
// Hopper blocks run in no order, so each block walks its rows (one warp per
// row, x and dy held in registers, mean / var / x_hat recomputed as the
// custom VJP of the JAX package does), keeps its columns' partial sums in
// registers, reduces its 8 warps in a fixed order through shared memory and
// writes one f32 [2, D] partial into a [n_blocks, 2, D] workspace; a
// second small kernel sums the partials in block order and casts to the
// scale's dtype. No atomics, so the result is the same from run to run.
//
// What bounds both on an H100: pure bandwidth. A [36 * 577, 768] bf16 call
// moves 32 MB in and 32 MB out (forward) or 64 MB in and 32 MB out
// (backward) at ~10-20 flops per element, far below the card's ~295
// flop/byte ridge, so the design goal is one read of each input and one
// write of each output with no shared-memory round trip, and enough bytes
// in flight to cover the memory's latency: in the forward, two rows a warp
// and as many warps an SM as registers sized to D allow. The backward's
// workspace is ~2 MB.

#include "common.cuh"

namespace {

using cxr::from_f32;
using cxr::to_f32;
using cxr::warp_sum;

constexpr int kMaxVecs = 8;          // 16-byte vectors per lane
constexpr int kRowsPerBlock = 8;     // backward: one warp per row
constexpr int kFwdWarps = 4;         // forward: warps of a block
constexpr int kMaxD = 32 * kMaxVecs * 8;

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
  const int lane = threadIdx.x & 31;
  const int nvec = D / E;

  uint32_t sw[V][kW], bw[V][kW];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      load_words(scale + vi * E, sw[i]);
      load_words(bias + vi * E, bw[i]);
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
    uint32_t nxt[V][4];
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
#pragma unroll
        for (int j = 0; j < E; ++j)
          o[j] = (elem<T>(cur[i], j) - mean) * rstd * elem<W>(sw[i], j) +
                 elem<W>(bw[i], j);
        uint4 out;
        if constexpr (sizeof(T) == 4)
          out = make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                           __float_as_uint(o[2]), __float_as_uint(o[3]));
        else
          out = make_uint4(cxr::pack_bf16x2(o[0], o[1]),
                           cxr::pack_bf16x2(o[2], o[3]),
                           cxr::pack_bf16x2(o[4], o[5]),
                           cxr::pack_bf16x2(o[6], o[7]));
        *reinterpret_cast<uint4*>(yr + vi * E) = out;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) cur[i][w] = nxt[i][w];
  }
}

// V = 16-byte vectors per lane (ceil(D / E / 32)): sized to D so that x,
// dy, the scale and the two partial sums of a row all stay in registers.
template <typename T, typename W, int V>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_bwd(const T* __restrict__ x, const W* __restrict__ scale,
       const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
       long long rows, int D, float eps) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float s_ds[kMaxD], s_db[kMaxD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D / E;

  float sc[V][E], ds[V][E], db[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vi = lane + i * 32;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      sc[i][j] = vi < nvec ? to_f32(scale[vi * E + j]) : 0.f;
      ds[i][j] = db[i][j] = 0.f;
    }
  }

  for (long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp;
       row < rows; row += static_cast<long long>(gridDim.x) * kRowsPerBlock) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float xv[V][E], gv[V][E];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        const uint4 xraw = *reinterpret_cast<const uint4*>(xr + vi * E);
        const uint4 graw = *reinterpret_cast<const uint4*>(gr + vi * E);
        const T* xe = reinterpret_cast<const T*>(&xraw);
        const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          xv[i][j] = to_f32(xe[j]);
          gv[i][j] = to_f32(ge[j]);
          sum += xv[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) xv[i][j] = gv[i][j] = 0.f;
      }
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (lane + i * 32 < nvec) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          xv[i][j] -= mean;
          sq += xv[i][j] * xv[i][j];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float xhat = xv[i][j] * rstd;  // 0 in lanes past D
        xv[i][j] = xhat;
        ds[i][j] += gv[i][j] * xhat;
        db[i][j] += gv[i][j];
        const float gs = gv[i][j] * sc[i][j];
        gv[i][j] = gs;
        sg += gs;
        sgx += gs * xhat;
      }
    }
    const float mg = warp_sum(sg) / D, mgx = warp_sum(sgx) / D;
    T* dxr = dx + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int j = 0; j < E; ++j)
          e[j] = from_f32<T>((gv[i][j] - mg - xv[i][j] * mgx) * rstd);
        *reinterpret_cast<uint4*>(dxr + vi * E) = raw;
      }
    }
  }

  // the block's partial sums: warps added in order 0..7
  for (int w = 0; w < kRowsPerBlock; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int vi = lane + i * 32;
        if (vi < nvec) {
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const int c = vi * E + j;
            s_ds[c] = w == 0 ? ds[i][j] : s_ds[c] + ds[i][j];
            s_db[c] = w == 0 ? db[i][j] : s_db[c] + db[i][j];
          }
        }
      }
    }
    __syncthreads();
  }
  float* pr = part + static_cast<long long>(blockIdx.x) * 2 * D;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    pr[c] = s_ds[c];
    pr[D + c] = s_db[c];
  }
}

// dscale and dbias: each thread sums one column of the [n_blocks, 2 * D]
// partials in block order.
template <typename W>
__global__ void __launch_bounds__(256)
ln_bwd_reduce(const float* __restrict__ part, int n_blocks, int D,
              W* __restrict__ dscale, W* __restrict__ dbias) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * D) return;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += part[static_cast<long long>(b) * 2 * D + c];
  if (c < D)
    dscale[c] = from_f32<W>(acc);
  else
    dbias[c - D] = from_f32<W>(acc);
}

// One wave: as many blocks as fit on the card at once (found once per
// instantiation and device), fewer when there are fewer rows.
template <typename T, typename W, int V>
cudaError_t launch_fwd_v(const void* x, const void* s, const void* b, void* y,
                         long long rows, int d, float eps, int device,
                         cudaStream_t st) {
  static int wave[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidValue;
  if (wave[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_fwd<T, W, V>, 32 * kFwdWarps, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    wave[device] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const long long need = (rows + kFwdWarps - 1) / kFwdWarps;
  const unsigned blocks =
      static_cast<unsigned>(need < wave[device] ? need : wave[device]);
  ln_fwd<T, W, V><<<blocks, 32 * kFwdWarps, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(s),
      static_cast<const W*>(b), static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_fwd(const void* x, const void* s, const void* b, void* y,
                       long long rows, int d, float eps, int device,
                       cudaStream_t st) {
  const int v = (d / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
#define CXR_LN_FWD(V) \
  if (v <= V) return launch_fwd_v<T, W, V>(x, s, b, y, rows, d, eps, device, st);
  CXR_LN_FWD(1)
  CXR_LN_FWD(2)
  CXR_LN_FWD(3)
  CXR_LN_FWD(4)
  CXR_LN_FWD(6)
  CXR_LN_FWD(8)
#undef CXR_LN_FWD
  return cudaErrorInvalidValue;
}

template <typename T, typename W, int V>
cudaError_t launch_bwd_v(const void* x, const void* s, const void* dy,
                         void* dx, void* ds, void* db, float* part,
                         long long rows, int d, float eps, int n_blocks,
                         cudaStream_t st) {
  ln_bwd<T, W, V><<<n_blocks, 32 * kRowsPerBlock, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(s),
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_reduce<W><<<(2 * d + 255) / 256, 256, 0, st>>>(
      part, n_blocks, d, static_cast<W*>(ds), static_cast<W*>(db));
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* s, const void* dy, void* dx,
                       void* ds, void* db, float* part, long long rows, int d,
                       float eps, int n_blocks, cudaStream_t st) {
  const int v = (d / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
#define CXR_LN_BWD(V)                                                     \
  if (v <= V)                                                             \
    return launch_bwd_v<T, W, V>(x, s, dy, dx, ds, db, part, rows, d, eps, \
                                 n_blocks, st);
  CXR_LN_BWD(1)
  CXR_LN_BWD(2)
  CXR_LN_BWD(3)
  CXR_LN_BWD(4)
  CXR_LN_BWD(6)
  CXR_LN_BWD(8)
#undef CXR_LN_BWD
  return cudaErrorInvalidValue;
}

bool bad_shape(long long rows, int d, int x_dtype) {
  const int vec = x_dtype == 1 ? 8 : 4;
  return rows <= 0 || d <= 0 || d % vec || d > 32 * kMaxVecs * vec;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x and y are contiguous [rows, d]
// with 16-byte aligned rows, scale and bias [d] 16-byte aligned;
// d <= 32 * 8 * (16 / sizeof(x)).
extern "C" int cxr_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, long long rows,
                                  int d, float eps, int x_dtype, int w_dtype,
                                  int device, void* stream) {
  if (bad_shape(rows, d, x_dtype)) return static_cast<int>(cudaErrorInvalidValue);
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

// x, dy, dx contiguous [rows, d] in x_dtype; scale, dscale, dbias [d] in
// w_dtype; workspace f32 [n_blocks, 2, d] (n_blocks >= 1, chosen by the
// caller; the result depends on it only through the f32 summation order).
extern "C" int cxr_layer_norm_bwd(const void* x, const void* scale,
                                  const void* dy, void* dx, void* dscale,
                                  void* dbias, void* workspace,
                                  long long rows, int d, float eps,
                                  int n_blocks, int x_dtype, int w_dtype,
                                  int device, void* stream) {
  if (bad_shape(rows, d, x_dtype) || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(workspace);
  if (x_dtype == 1 && w_dtype == 1)
    err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, dscale, dbias,
                                                   part, rows, d, eps, n_blocks, st);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch_bwd<__nv_bfloat16, float>(x, scale, dy, dx, dscale, dbias, part,
                                           rows, d, eps, n_blocks, st);
  else if (x_dtype == 0 && w_dtype == 0)
    err = launch_bwd<float, float>(x, scale, dy, dx, dscale, dbias, part, rows, d,
                                   eps, n_blocks, st);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch_bwd<float, __nv_bfloat16>(x, scale, dy, dx, dscale, dbias, part,
                                           rows, d, eps, n_blocks, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
