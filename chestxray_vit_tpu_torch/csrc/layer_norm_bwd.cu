// LayerNorm backward over the last dim (layer_norm.cuh has what it shares
// with the forward, layer_norm.cu): dx = (g - mean(g) - x_hat *
// mean(g * x_hat)) * rstd with g = dy * scale, and dscale = sum over rows
// of dy * x_hat, dbias = sum of dy. Replaces `_ln_bwd_kernel` (launched by
// `_bwd_pallas`), which sums the parameter gradients across a *sequential*
// row-block grid in VMEM scratch. Hopper blocks run in no order, so the
// sum over rows is taken in an order fixed by block and warp index: each
// warp of a block walks rows (one wave of resident blocks), keeping x and
// dy as packed words and its lanes' dscale / dbias columns as f32 sums in
// registers, with the next row's loads issued before the current row's
// reductions (mean and var recomputed as the custom VJP of the JAX package
// does: sum x with sum g in one butterfly, then the centered sum of
// squares with sum g * (x - mean)); the scale sits in shared memory. The
// block's warps combine in a fixed tree through shared memory and write
// one f32 [2, D] partial into a [n_blocks, 2, D] workspace; a column pass
// (`ln_bwd_cols`: 32 columns a block, its warps each summing a fixed share
// of the partials as 128-byte rows, then in warp order) adds them and
// casts to the scale's dtype. No atomics, so the result is the same from
// run to run.
//
// What bounds it on an H100: pure bandwidth. A [36 * 577, 768] bf16 call
// moves 64 MB in and 32 MB out at ~10-20 flops per element, so the design
// goal is one read of each input and one write of each output with no
// shared-memory round trip, and enough bytes in flight to cover the
// memory's latency: two rows a warp and as many warps an SM as registers
// sized to D allow (at D = 768, two blocks of eight warps). The
// workspace is ~1.6 MB.
//
// D up to 2048 in both dtypes on the rungs. An f32 row of more than 1024
// columns takes up to sixteen vectors a lane; then x, dy, their next row
// and the dscale / dbias sums no longer fit in registers: those rungs
// (kBig) keep one row a warp in flight and the per-warp sums in shared
// memory (lane-minor, so no bank conflicts), which the fixed tree then
// adds in place.
//
// Any other D: ln_bwd_any keeps what the rungs keep on chip at any width
// its rows fit in registers (AnyRows: a warp a row off the vector up to 256
// elements, a block a row up to 4096 off the vector or past 2048 in whole
// vectors, 2 to 4 a thread, bf16 D <= 8192, f32 D <= 4096); the row's x
// and dy are read from device memory once into registers, the next row's
// loads are issued before the current row's two reductions (the block
// form's through shared memory, one barrier each), the scale is read once
// a block into shared memory, and each thread's dscale / dbias sums of its
// own columns stay in registers across all its rows and are written once
// a block into the [n_blocks, 2, D] workspace that the same column pass
// adds.
//
// Wider rows (bf16 D > 8192 in whole vectors, any other D > 4096) take
// layer_norm_bwd_wide.cu: a Hopper thread block cluster a row of whole
// vectors, or (off the vector, or past a cluster of eight) two passes;
// layer_norm_bwd.cuh has what the two units share (the call, the any-D
// layout, the column pass).

#include "layer_norm_bwd.cuh"

namespace {

using namespace cxr::ln;

constexpr int kBwdWarps = 8;         // backward: warps of a block

// The backward's layout at V 16-byte vectors a lane.
template <typename T, typename W, int V>
struct Bwd {
  static constexpr int E = 16 / sizeof(T);      // elements per vector
  static constexpr int kW = E * sizeof(W) / 4;  // words of E scale values
  static constexpr int kAcc = 2 * V * E;        // a lane's dscale, dbias sums
  // kBig: no next row in flight, and the sums in shared memory
  static constexpr bool kBig = V > kMaxVecs;
  // Two blocks an SM (at most 128 registers a thread) where the row in
  // hand, the next row (x and dy, packed) and the sums take at most 96.
  static constexpr int kMinBlocks = !kBig && 16 * V + kAcc <= 96 ? 2 : 1;
  // Dynamic shared memory: the scale, then the slots of the warps' sums,
  // lane-minor ([slot][kAcc][32] floats): kBwdWarps / 2 for the tree, or
  // one a warp where the sums live there (kBig).
  static constexpr int kSlots = kBig ? kBwdWarps : kBwdWarps / 2;
  __host__ __device__ static constexpr int scale_bytes(int d) {
    return (d * static_cast<int>(sizeof(W)) + 15) / 16 * 16;
  }
  __host__ __device__ static constexpr int smem(int d) {
    return scale_bytes(d) + kSlots * kAcc * 32 * 4;
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
  constexpr bool kBig = L::kBig;
  constexpr int kReg = kBig ? 1 : V;  // vectors of sums and of the next row
  extern __shared__ __align__(16) unsigned char smem[];
  W* s_scale = reinterpret_cast<W*>(smem);
  float* s_tree = reinterpret_cast<float*>(smem + L::scale_bytes(D));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D / E;
  // kBig: this warp's sums, [kAcc][32] lane-minor (dscale, then dbias)
  float* s_mine = s_tree + warp * kAcc * 32 + lane;

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
  if constexpr (kBig) {
#pragma unroll
    for (int a = 0; a < kAcc; ++a) s_mine[a * 32] = 0.f;
  }
  __syncthreads();

  float ds[kReg][E], db[kReg][E];
#pragma unroll
  for (int i = 0; i < kReg; ++i)
#pragma unroll
    for (int j = 0; j < E; ++j) ds[i][j] = db[i][j] = 0.f;

  for (; row < rows; row += step) {
    uint32_t nx[kReg][4], ng[kReg][4];
    if constexpr (!kBig)
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
          if constexpr (kBig) {
            s_mine[(i * E + j) * 32] += gy * xh;
            s_mine[((V + i) * E + j) * 32] += gy;
          } else {
            ds[i][j] += gy * xh;
            db[i][j] += gy;
          }
          o[j] = (gy * elem<W>(sw, j) - mg - xh * mgx) * rstd;
        }
        store_vec(dxr + vi * E, o);
      }
    }
    if constexpr (kBig) {
      if (row + step < rows) fetch(row + step, cx, cg);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          cx[i][w] = nx[i][w];
          cg[i][w] = ng[i][w];
        }
    }
  }

  // The block's sums, warps combined in a fixed tree: at each level the
  // upper half of the warps still holding sums writes to shared memory and
  // the lower half adds them (warp w + half into warp w). kBig: the sums
  // are in shared memory already, and warp w adds warp w + half's in place.
  if constexpr (kBig) {
    __syncthreads();
#pragma unroll
    for (int half = kBwdWarps / 2; half > 0; half /= 2) {
      if (warp < half) {
        const float* other = s_mine + half * kAcc * 32;
#pragma unroll 8
        for (int a = 0; a < kAcc; ++a) s_mine[a * 32] += other[a * 32];
      }
      __syncthreads();
    }
  } else {
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
  }
  if (warp == 0) {
    float* pr = part + static_cast<long long>(blockIdx.x) * 2 * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        float sd[E], sb[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if constexpr (kBig) {
            sd[j] = s_mine[(i * E + j) * 32];
            sb[j] = s_mine[((V + i) * E + j) * 32];
          } else {
            sd[j] = ds[i][j];
            sb[j] = db[i][j];
          }
        }
#pragma unroll
        for (int h = 0; h < E / 4; ++h) {
          reinterpret_cast<float4*>(pr + vi * E)[h] =
              make_float4(sd[4 * h], sd[4 * h + 1], sd[4 * h + 2],
                          sd[4 * h + 3]);
          reinterpret_cast<float4*>(pr + D + vi * E)[h] =
              make_float4(sb[4 * h], sb[4 * h + 1], sb[4 * h + 2],
                          sb[4 * h + 3]);
        }
      }
    }
  }
}

// Rows walked by warps (kWarpRow) or by whole blocks, each held in
// registers as raw words from one read of x and dy, with the next row's
// loads issued before the current row's two reductions; the scale read
// once a block into shared memory; each thread's dscale / dbias sums of
// its own columns kept in registers across all its rows and written once
// (kWarpRow: the warps added in warp order first) into the block's row of
// the [n_blocks, 2, D] workspace.
template <typename T, typename W, bool kVec, bool kWarpRow, int V>
__global__ void __launch_bounds__(
    kAnyThreads, (AnyBwd<T, W, kVec, kWarpRow, V>::kMinBlocks))
ln_bwd_any(const T* __restrict__ x, const W* __restrict__ scale,
           const T* __restrict__ dy, T* __restrict__ dx,
           float* __restrict__ part, long long rows, int D, float eps) {
  using L = AnyBwd<T, W, kVec, kWarpRow, V>;
  using R = typename L::R;
  using Q = Params<W, L::kE>;  // the scale's pieces, from shared memory
  static_assert(!(kWarpRow && kVec), "a warp a row off the vector only");
  constexpr int E = L::kE, kWd = R::kWords;
  extern __shared__ __align__(16) unsigned char smem[];
  W* s_scale = reinterpret_cast<W*>(smem);
  float* s_aux = reinterpret_cast<float*>(smem + L::scale_bytes(D));
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
  uint32_t cx[V][kWd], cg[V][kWd];
  auto fetch = [&](long long r, uint32_t (&xw)[V][kWd],
                   uint32_t (&gw)[V][kWd]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        R::load(x + r * D, p, xw[i]);
        R::load(dy + r * D, p, gw[i]);
      }
    }
  };
  if (row < rows) fetch(row, cx, cg);  // in flight while the scale is read
  for (int c = threadIdx.x; c < D; c += blockDim.x) s_scale[c] = scale[c];
  __syncthreads();

  // Two sums over the row's threads: a warp's butterfly, and in the block
  // form the warps' partials through one of two buffers in turn (the
  // barrier of one reduction orders the reads of the buffer before it
  // against the writes of the one after it), added in warp order.
  int buf = 0;
  auto row_sum2 = [&](float& a, float& b) {
    warp_sum2(a, b);
    if constexpr (!kWarpRow) {
      float* red = s_aux + buf * 2 * kAnyWarps;
      if (lane == 0) {
        red[warp] = a;
        red[kAnyWarps + warp] = b;
      }
      __syncthreads();
      a = b = 0.f;
#pragma unroll
      for (int w = 0; w < kAnyWarps; ++w)
        if (w < nw) {
          a += red[w];
          b += red[kAnyWarps + w];
        }
      buf ^= 1;
    }
  };

  float ds[V][E], db[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int j = 0; j < E; ++j) ds[i][j] = db[i][j] = 0.f;

  for (; row < rows; row += step) {  // uniform over the row's threads
    uint32_t nx[V][kWd], ng[V][kWd];
    if (row + step < rows) fetch(row + step, nx, ng);

    float sx = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        uint32_t sv[Q::kWords];
        Q::load(s_scale, p, sv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          sx += R::at(cx[i], j);
          sg += R::at(cg[i], j) * Q::at(sv, j);
        }
      }
    }
    row_sum2(sx, sg);
    const float mean = sx / D;
    float sq = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        uint32_t sv[Q::kWords];
        Q::load(s_scale, p, sv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float d = R::at(cx[i], j) - mean;
          sq += d * d;
          sgx += R::at(cg[i], j) * Q::at(sv, j) * d;
        }
      }
    }
    row_sum2(sq, sgx);
    const float rstd = rsqrtf(sq / D + eps);
    const float mg = sg / D, mgx = sgx * rstd / D;  // mean(g), mean(g x_hat)
    T* dxr = dx + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        float o[E];
        uint32_t sv[Q::kWords];
        Q::load(s_scale, p, sv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float xh = (R::at(cx[i], j) - mean) * rstd;
          const float gy = R::at(cg[i], j);
          ds[i][j] += gy * xh;
          db[i][j] += gy;
          o[j] = (gy * Q::at(sv, j) - mg - xh * mgx) * rstd;
        }
        R::store(dxr, p, o);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int w = 0; w < kWd; ++w) {
        cx[i][w] = nx[i][w];
        cg[i][w] = ng[i][w];
      }
  }

  float* pr = part + static_cast<long long>(blockIdx.x) * 2 * D;
  if constexpr (kWarpRow) {
    // the warps' sums added in warp order by warp 0
    float* mine = s_aux + warp * 2 * V * 32 + lane;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mine[i * 32] = ds[i][0];
      mine[(V + i) * 32] = db[i][0];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int p = lane + i * 32;
        float sd = 0.f, sb = 0.f;
#pragma unroll
        for (int w = 0; w < kAnyWarps; ++w) {
          sd += s_aux[(w * 2 * V + i) * 32 + lane];
          sb += s_aux[(w * 2 * V + V + i) * 32 + lane];
        }
        if (p < np) {
          pr[p] = sd;
          pr[D + p] = sb;
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        if constexpr (kVec) {
#pragma unroll
          for (int h = 0; h < E / 4; ++h) {
            reinterpret_cast<float4*>(pr + p * E)[h] =
                make_float4(ds[i][4 * h], ds[i][4 * h + 1], ds[i][4 * h + 2],
                            ds[i][4 * h + 3]);
            reinterpret_cast<float4*>(pr + D + p * E)[h] =
                make_float4(db[i][4 * h], db[i][4 * h + 1], db[i][4 * h + 2],
                            db[i][4 * h + 3]);
          }
        } else {
          pr[p] = ds[i][0];
          pr[D + p] = db[i][0];
        }
      }
    }
  }
}

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
  return launch_cols<W>(c);
}

// The any-D backward at a width its rows fit in registers (ln_bwd_any) and
// the column pass, or its wave.
template <typename T, typename W, bool kVec, bool kWarpRow, int V>
cudaError_t run_bwd_any(const BwdCall& c) {
  using L = AnyBwd<T, W, kVec, kWarpRow, V>;
  static int cache[kAnyWarps][64] = {};  // by the block's warps
  const int threads = L::threads(c.d);
  int wave = 0;  // also allows the widest row's shared memory
  cudaError_t err =
      wave_of(ln_bwd_any<T, W, kVec, kWarpRow, V>, threads,
              L::smem(L::kMaxD), c.device, cache[threads / 32 - 1], &wave);
  if (err != cudaSuccess) return err;
  if (c.wave) {
    *c.wave = wave;
    return cudaSuccess;
  }
  ln_bwd_any<T, W, kVec, kWarpRow, V>
      <<<c.n_blocks, threads, L::smem(c.d), c.st>>>(
          static_cast<const T*>(c.x), static_cast<const W*>(c.scale),
          static_cast<const T*>(c.dy), static_cast<T*>(c.dx), c.part, c.rows,
          c.d, c.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_cols<W>(c);
}

// Any D off the rungs: whole 16-byte vectors (D past 2048) take a block a
// row, 2 to 4 vectors a thread (bf16 D <= 8192, f32 D <= 4096); a D off
// the vector takes a warp a row up to 256 elements (1, 2, 4 or 8 a lane),
// a block a row up to 4096 (2, 4, 8 or 16 a thread); wider rows a cluster
// of blocks a row (whole vectors up to a cluster of eight), or the
// two-pass form (run_bwd_wide).
template <typename T, typename W>
cudaError_t run_bwd_off_rungs(const BwdCall& c) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  if (c.d % E == 0) {
    const int v = (c.d / E + kAnyThreads - 1) / kAnyThreads;
    if (v <= 2) return run_bwd_any<T, W, true, false, 2>(c);
    if (v <= 3) return run_bwd_any<T, W, true, false, 3>(c);
    if (v <= 4) return run_bwd_any<T, W, true, false, 4>(c);
    return run_bwd_wide<T, W, true>(c);
  }
  if (c.d <= 32 * 8) {
    const int v = (c.d + 31) / 32;
    if (v <= 1) return run_bwd_any<T, W, false, true, 1>(c);
    if (v <= 2) return run_bwd_any<T, W, false, true, 2>(c);
    if (v <= 4) return run_bwd_any<T, W, false, true, 4>(c);
    return run_bwd_any<T, W, false, true, 8>(c);
  }
  const int v = (c.d + kAnyThreads - 1) / kAnyThreads;
  if (v <= 2) return run_bwd_any<T, W, false, false, 2>(c);
  if (v <= 4) return run_bwd_any<T, W, false, false, 4>(c);
  if (v <= 8) return run_bwd_any<T, W, false, false, 8>(c);
  if (v <= 16) return run_bwd_any<T, W, false, false, 16>(c);
  return run_bwd_wide<T, W, false>(c);
}

template <typename T, typename W>
cudaError_t run_bwd(const BwdCall& c) {
  if (!on_rungs<T>(c.d)) return run_bwd_off_rungs<T, W>(c);
  const int v = (c.d / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
#define CXR_LN_BWD(V) \
  if (v <= V) return run_bwd_v<T, W, V>(c);
  CXR_LN_BWD(1)
  CXR_LN_BWD(2)
  CXR_LN_BWD(3)
  CXR_LN_BWD(4)
  CXR_LN_BWD(6)
  CXR_LN_BWD(8)
  if constexpr (sizeof(T) == 4) {  // f32 rows of more than 1024 columns
    CXR_LN_BWD(12)
    CXR_LN_BWD(16)
  }
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

}  // namespace

// x, dy, dx contiguous [rows, d] in x_dtype from 16-byte aligned addresses;
// scale, dscale, dbias [d] in w_dtype; workspace f32 [n_blocks, 2, d],
// 16-byte aligned (n_blocks >= 1, chosen by the caller, best
// cxr_layer_norm_bwd_wave's or fewer; the result depends on it only
// through the f32 summation order). n_blocks counts blocks on the rungs
// and in ln_bwd_any, clusters of blocks past ln_bwd_any's widths (bf16 d >
// 8192 in whole vectors, f32 d > 4096 in whole vectors), and ranges of
// rows in the two-pass form (d > 4096 off the vector; bf16 d > 65536, f32
// d > 32768). The two-pass form also writes four f32 a row after the
// partials: there, and only there, the workspace must hold [n_blocks, 2,
// d] then [rows, 4] (ops/layer_norm._bwd_workspace); the library cannot
// see its size.
extern "C" int cxr_layer_norm_bwd(const void* x, const void* scale,
                                  const void* dy, void* dx, void* dscale,
                                  void* dbias, void* workspace,
                                  long long rows, int d, float eps,
                                  int n_blocks, int x_dtype, int w_dtype,
                                  int device, void* stream) {
  if (bad_shape(rows, d) || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdCall c{x, scale, dy, dx, dscale, dbias,
                  static_cast<float*>(workspace), rows, d, eps, n_blocks,
                  device, static_cast<cudaStream_t>(stream), nullptr};
  return static_cast<int>(run_bwd_types(x_dtype, w_dtype, c));
}

// *blocks = the backward's blocks (clusters, ranges: as n_blocks counts
// them) resident on `device` at once for this d and these dtypes: one
// wave, the workspace's size for any row count.
extern "C" int cxr_layer_norm_bwd_wave(int d, int x_dtype, int w_dtype,
                                       int device, int* blocks) {
  if (bad_shape(1, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdCall c{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, 1, d, 0.f, 1, device, nullptr, blocks};
  return static_cast<int>(run_bwd_types(x_dtype, w_dtype, c));
}
