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
// Hopper blocks run in no order, so the sum over rows is taken in an order
// fixed by block and warp index: each warp of a block walks rows (one wave
// of resident blocks), keeping x and dy as packed words and its lanes'
// dscale / dbias columns as f32 sums in registers, with the next row's
// loads issued before the current row's reductions (mean and var recomputed
// as the custom VJP of the JAX package does: sum x with sum g in one
// butterfly, then the centered sum of squares with sum g * (x - mean)); the
// scale sits in shared memory. The block's warps combine in a fixed tree
// through shared memory and write one f32 [2, D] partial into a
// [n_blocks, 2, D] workspace; a column pass (`ln_bwd_cols`: 32 columns a
// block, its warps each summing a fixed share of the partials as 128-byte
// rows, then in warp order) adds them and casts to the scale's dtype. No
// atomics, so the result is the same from run to run.
//
// What bounds both on an H100: pure bandwidth. A [36 * 577, 768] bf16 call
// moves 32 MB in and 32 MB out (forward) or 64 MB in and 32 MB out
// (backward) at ~10-20 flops per element, far below the card's ~295
// flop/byte ridge, so the design goal is one read of each input and one
// write of each output with no shared-memory round trip, and enough bytes
// in flight to cover the memory's latency: two rows a warp and as many
// warps an SM as registers sized to D allow (in the backward at D = 768,
// two blocks of eight warps). The backward's workspace is ~1.6 MB.

#include "common.cuh"

namespace {

using cxr::from_f32;
using cxr::warp_sum;

constexpr int kMaxVecs = 8;          // 16-byte vectors per lane
constexpr int kFwdWarps = 4;         // forward: warps of a block
constexpr int kBwdWarps = 8;         // backward: warps of a block
constexpr int kColWarps = 32;        // column pass: warps of a block

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
        store_vec(yr + vi * E, o);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) cur[i][w] = nxt[i][w];
  }
}

// The backward's layout at V 16-byte vectors a lane.
template <typename T, typename W, int V>
struct Bwd {
  static constexpr int E = 16 / sizeof(T);      // elements per vector
  static constexpr int kW = E * sizeof(W) / 4;  // words of E scale values
  static constexpr int kAcc = 2 * V * E;        // a lane's dscale, dbias sums
  // Two blocks an SM (at most 128 registers a thread) where the row in
  // hand, the next row (x and dy, packed) and the sums take at most 96.
  static constexpr int kMinBlocks = 16 * V + kAcc <= 96 ? 2 : 1;
  // Dynamic shared memory: the scale, then kBwdWarps / 2 slots of the
  // warps' sums for the tree, lane-minor ([slot][kAcc][32] floats).
  __host__ __device__ static constexpr int scale_bytes(int d) {
    return (d * static_cast<int>(sizeof(W)) + 15) / 16 * 16;
  }
  __host__ __device__ static constexpr int smem(int d) {
    return scale_bytes(d) + kBwdWarps / 2 * kAcc * 32 * 4;
  }
  static constexpr int kMaxD = 32 * V * E;
};

template <typename T, typename W, int V>
__global__ void __launch_bounds__(32 * kBwdWarps, (Bwd<T, W, V>::kMinBlocks))
ln_bwd(const T* __restrict__ x, const W* __restrict__ scale,
       const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
       long long rows, int D, float eps) {
  using L = Bwd<T, W, V>;
  constexpr int E = L::E, kAcc = L::kAcc;
  extern __shared__ __align__(16) unsigned char smem[];
  W* s_scale = reinterpret_cast<W*>(smem);
  float* s_tree = reinterpret_cast<float*>(smem + L::scale_bytes(D));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D / E;

  const long long step = static_cast<long long>(gridDim.x) * kBwdWarps;
  long long row = static_cast<long long>(blockIdx.x) * kBwdWarps + warp;
  uint32_t cx[V][4], cg[V][4];
  auto fetch = [&](long long r, uint32_t (&xw)[V][4], uint32_t (&gw)[V][4]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        load_words(x + r * D + vi * E, xw[i]);
        load_words(dy + r * D + vi * E, gw[i]);
      }
    }
  };
  if (row < rows) fetch(row, cx, cg);  // in flight while the scale is read

  for (int c = threadIdx.x; c < D; c += blockDim.x) s_scale[c] = scale[c];
  __syncthreads();

  float ds[V][E], db[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int j = 0; j < E; ++j) ds[i][j] = db[i][j] = 0.f;

  for (; row < rows; row += step) {
    uint32_t nx[V][4], ng[V][4];
    if (row + step < rows) fetch(row + step, nx, ng);

    float sx = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        uint32_t sw[L::kW];
        load_words(s_scale + vi * E, sw);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          sx += elem<T>(cx[i], j);
          sg += elem<T>(cg[i], j) * elem<W>(sw, j);
        }
      }
    }
    warp_sum2(sx, sg);
    const float mean = sx / D;
    float sq = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        uint32_t sw[L::kW];
        load_words(s_scale + vi * E, sw);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float d = elem<T>(cx[i], j) - mean;
          sq += d * d;
          sgx += elem<T>(cg[i], j) * elem<W>(sw, j) * d;
        }
      }
    }
    warp_sum2(sq, sgx);
    const float rstd = rsqrtf(sq / D + eps);
    const float mg = sg / D, mgx = sgx * rstd / D;  // mean(g), mean(g x_hat)
    T* dxr = dx + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        uint32_t sw[L::kW];
        load_words(s_scale + vi * E, sw);
        float o[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float xh = (elem<T>(cx[i], j) - mean) * rstd;
          const float gy = elem<T>(cg[i], j);
          ds[i][j] += gy * xh;
          db[i][j] += gy;
          o[j] = (gy * elem<W>(sw, j) - mg - xh * mgx) * rstd;
        }
        store_vec(dxr + vi * E, o);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        cx[i][w] = nx[i][w];
        cg[i][w] = ng[i][w];
      }
  }

  // The block's sums, warps combined in a fixed tree: at each level the
  // upper half of the warps still holding sums writes to shared memory and
  // the lower half adds them (warp w + half into warp w).
#pragma unroll
  for (int half = kBwdWarps / 2; half > 0; half /= 2) {
    float* slot = s_tree + (warp & (half - 1)) * kAcc * 32 + lane;
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int j = 0; j < E; ++j) {
          slot[(i * E + j) * 32] = ds[i][j];
          slot[((V + i) * E + j) * 32] = db[i][j];
        }
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int j = 0; j < E; ++j) {
          ds[i][j] += slot[(i * E + j) * 32];
          db[i][j] += slot[((V + i) * E + j) * 32];
        }
    }
    __syncthreads();
  }
  if (warp == 0) {
    float* pr = part + static_cast<long long>(blockIdx.x) * 2 * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
#pragma unroll
        for (int h = 0; h < E / 4; ++h) {
          reinterpret_cast<float4*>(pr + vi * E)[h] =
              make_float4(ds[i][4 * h], ds[i][4 * h + 1], ds[i][4 * h + 2],
                          ds[i][4 * h + 3]);
          reinterpret_cast<float4*>(pr + D + vi * E)[h] =
              make_float4(db[i][4 * h], db[i][4 * h + 1], db[i][4 * h + 2],
                          db[i][4 * h + 3]);
        }
      }
    }
  }
}

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
      dscale[c] = from_f32<W>(t);
    else
      dbias[c - D] = from_f32<W>(t);
  }
}

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

template <typename T, typename W, int V>
cudaError_t run_bwd_v(const BwdCall& c) {
  using L = Bwd<T, W, V>;
  static int cache[64] = {};
  int wave = 0;  // also allows the rung's shared memory
  cudaError_t err = wave_of(ln_bwd<T, W, V>, 32 * kBwdWarps,
                            L::smem(L::kMaxD), c.device, cache, &wave);
  if (err != cudaSuccess) return err;
  if (c.wave) {
    *c.wave = wave;
    return cudaSuccess;
  }
  ln_bwd<T, W, V><<<c.n_blocks, 32 * kBwdWarps, L::smem(c.d), c.st>>>(
      static_cast<const T*>(c.x), static_cast<const W*>(c.scale),
      static_cast<const T*>(c.dy), static_cast<T*>(c.dx), c.part, c.rows,
      c.d, c.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_cols<W><<<(2 * c.d + 31) / 32, 32 * kColWarps, 0, c.st>>>(
      c.part, c.n_blocks, c.d, static_cast<W*>(c.dscale),
      static_cast<W*>(c.dbias));
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t run_bwd(const BwdCall& c) {
  const int v = (c.d / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
#define CXR_LN_BWD(V) \
  if (v <= V) return run_bwd_v<T, W, V>(c);
  CXR_LN_BWD(1)
  CXR_LN_BWD(2)
  CXR_LN_BWD(3)
  CXR_LN_BWD(4)
  CXR_LN_BWD(6)
  CXR_LN_BWD(8)
#undef CXR_LN_BWD
  return cudaErrorInvalidValue;
}

cudaError_t run_bwd_types(int x_dtype, int w_dtype, const BwdCall& c) {
  using bf16 = __nv_bfloat16;
  if (x_dtype == 1 && w_dtype == 1) return run_bwd<bf16, bf16>(c);
  if (x_dtype == 1 && w_dtype == 0) return run_bwd<bf16, float>(c);
  if (x_dtype == 0 && w_dtype == 0) return run_bwd<float, float>(c);
  if (x_dtype == 0 && w_dtype == 1) return run_bwd<float, bf16>(c);
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

// x, dy, dx contiguous [rows, d] in x_dtype with 16-byte aligned rows;
// scale, dscale, dbias [d] in w_dtype; workspace f32 [n_blocks, 2, d],
// 16-byte aligned (n_blocks >= 1, chosen by the caller, best
// cxr_layer_norm_bwd_wave's or fewer; the result depends on it only
// through the f32 summation order).
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
  const BwdCall c{x, scale, dy, dx, dscale, dbias,
                  static_cast<float*>(workspace), rows, d, eps, n_blocks,
                  device, static_cast<cudaStream_t>(stream), nullptr};
  return static_cast<int>(run_bwd_types(x_dtype, w_dtype, c));
}

// *blocks = the backward's blocks resident on `device` at once for this d
// and these dtypes: one wave, the workspace's size for any row count.
extern "C" int cxr_layer_norm_bwd_wave(int d, int x_dtype, int w_dtype,
                                       int device, int* blocks) {
  if (bad_shape(1, d, x_dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdCall c{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, 1, d, 0.f, 1, device, nullptr, blocks};
  return static_cast<int>(run_bwd_types(x_dtype, w_dtype, c));
}
